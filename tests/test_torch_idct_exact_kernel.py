"""Kernel E1's wrapper, `ops/kernels.py::idct_exact_batch` (the exact
tier's dequantize + int32 IDCT over every component of a group), on the
CPU, where it runs its plain version segment by segment.

- Bit-equal to the JAX package's jnp `dequantize_and_idct_blocks`, image
  by image: groups of 1, 3 and 16 images with per-image 8- and 16-bit
  tables, scales 8/4/2/1, mixed scales in one call, an empty component and
  more than 64 segments; inputs from numpy seeds, the integer corners of
  `torch_inputs.adversarial_blocks` included (full-range coefficients
  times 16-bit tables, zeroed AC columns under large DC).
- The segment table: images that share a table tensor merge into one
  segment per component, their bits those of per-image calls; more than
  64 segments take more than one launch's table.
- A `meta` tensor raises.
- `_planes` at exact calls the wrapper once per group (stream batches,
  prefix, the `Decoder`), and the stripes once per stripe (counted with
  monkeypatch).
- Every literal constant of `csrc/idct_exact.cu` equals its value in the
  host copy's `host/ops/idct.py`.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeg_decoder_tpu_torch as jt
import jpeg_decoder_tpu_torch.host.ops.idct as host_idct
from jpeg_decoder_tpu.ops.idct import dequantize_and_idct_blocks as ref_idct
from jpeg_decoder_tpu_torch.ops import kernels
from jpeg_decoder_tpu_torch.ops.kernels import (MAX_SEGMENTS, _segments,
                                                idct_exact_batch)
from jpeg_decoder_tpu_torch.parallel import decode_striped, make_mesh
from jpeg_decoder_tpu_torch.parallel.stripe_bits import decode_bits_striped

from test_torch_batch import _one_torch_thread  # noqa: F401
from test_torch_mesh import _stores
from torch_inputs import adversarial_blocks, fixture, stripe_case

CU = Path(kernels.__file__).resolve().parent.parent / "csrc" / "idct_exact.cu"
BLOCKS = 40         # blocks per image and component: one jnp shape


def _tables(rng, n: int, bits: int) -> list:
    """n uint16 [64] tables, 8- or 16-bit."""
    return [rng.integers(1, 1 << bits, 64).astype(np.uint16)
            for _ in range(n)]


def _coefs(rng, n: int, blocks: int = BLOCKS) -> np.ndarray:
    """int16 [n, blocks, 64]: half full-range, half small, some blocks
    with every AC column zero under a full-range DC."""
    c = rng.integers(-32768, 32768, (n, blocks, 64)).astype(np.int16)
    c[:, : blocks // 2] = rng.integers(-64, 64, (n, blocks // 2, 64))
    grid = c.reshape(n, blocks, 8, 8)
    grid[:, blocks - 6:, 1:, :] = 0
    grid[:, blocks - 9: blocks - 6, 1:, rng.integers(0, 8)] = 0
    return c


def _want(coef: np.ndarray, qt: np.ndarray, scale: int) -> np.ndarray:
    """The JAX package's jnp exact IDCT of one image's [m, 64] blocks:
    uint8 [m, scale * scale]."""
    got = np.asarray(ref_idct(jnp.asarray(coef), jnp.asarray(qt), scale,
                              xp=jnp))
    return got.reshape(coef.shape[0], scale * scale)


def _run(coefs: list, tabs: list, scales: list, shared=None) -> list:
    """idct_exact_batch on CPU tensors; tabs[c][i] the uint16 table of
    component c of image i. `shared` maps equal tables to one tensor, as
    `params.qt_exact` does."""
    def q(t):
        if shared is None:
            return torch.from_numpy(t.astype(np.int32))
        return shared.setdefault(t.tobytes(),
                                 torch.from_numpy(t.astype(np.int32)))

    return idct_exact_batch([torch.from_numpy(c) for c in coefs],
                            [[q(t) for t in tc] for tc in tabs], scales)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("n", [1, 3, 16])
@pytest.mark.parametrize("scale", [8, 4, 2, 1])
def test_batch_bit_equal_to_jnp(n, scale, bits):
    """Three components of n images with per-image tables: every image's
    pixels those of the jnp IDCT on its own."""
    rng = np.random.default_rng(100 * n + 10 * scale + bits)
    coefs = [_coefs(rng, n) for _ in range(3)]
    tabs = [_tables(rng, n, bits) for _ in range(3)]
    got = _run(coefs, tabs, [scale] * 3)
    for c in range(3):
        assert got[c].dtype == torch.uint8
        assert tuple(got[c].shape) == (n, BLOCKS, scale * scale)
        for i in range(n):
            np.testing.assert_array_equal(
                got[c][i].numpy(), _want(coefs[c][i], tabs[c][i], scale))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scale", [8, 4, 2, 1])
def test_adversarial_bit_equal_to_jnp(seed, scale):
    """`adversarial_blocks` split into three images of one component, with
    its 16-bit table for one image and the table reversed or rolled for
    the others."""
    coef, qt = adversarial_blocks(seed, n=300)
    imgs = coef.reshape(3, 100, 64)
    tabs = [qt, qt[::-1].copy(), np.roll(qt, 5)]
    got = _run([imgs], [tabs], [scale])[0]
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(),
                                      _want(imgs[i], tabs[i], scale))


def test_mixed_scales_and_an_empty_component():
    """One call with a component at each scale, one of no blocks, and one
    image whose blocks differ in count per component."""
    rng = np.random.default_rng(7)
    scales = [8, 4, 8, 2, 1]
    coefs = [_coefs(rng, 3, b) for b in (BLOCKS, 24, 0, 16, 9)]
    tabs = [_tables(rng, 3, 16) for _ in scales]
    got = _run(coefs, tabs, scales)
    for c, (coef, scale) in enumerate(zip(coefs, scales)):
        assert tuple(got[c].shape) == (3, coef.shape[1], scale * scale)
        for i in range(3 if coef.shape[1] else 0):
            np.testing.assert_array_equal(
                got[c][i].numpy(), _want(coef[i], tabs[c][i], scale))


def test_more_than_64_segments():
    """17 images x 4 components, each with its own table: 68 segments,
    more than one launch's table (MAX_SEGMENTS), every image bit-equal."""
    rng = np.random.default_rng(68)
    n, blocks = 17, 8
    coefs = [_coefs(rng, n, blocks) for _ in range(4)]
    tabs = [_tables(rng, n, 16) for _ in range(4)]
    got = _run(coefs, tabs, [8, 8, 4, 4])
    for c, scale in enumerate([8, 8, 4, 4]):
        for i in range(n):
            np.testing.assert_array_equal(
                got[c][i].numpy(), _want(coefs[c][i], tabs[c][i], scale))
    tensors = [torch.from_numpy(c) for c in coefs]
    qs = [[torch.from_numpy(t.astype(np.int32)) for t in tc] for tc in tabs]
    outs = [torch.empty((n, blocks, s * s), dtype=torch.uint8)
            for s in (8, 8, 4, 4)]
    segs = _segments(tensors, qs, outs, [8, 8, 4, 4])
    assert len(segs) == 4 * n > MAX_SEGMENTS
    assert -(-len(segs) // MAX_SEGMENTS) == 2


@pytest.mark.parametrize("n", [3, 16])
def test_shared_tables_merge_and_keep_the_bits(n):
    """Images of one encoder share one table tensor per component: the
    segment table holds one segment per component, and the pixels equal
    the per-image calls'. Per-image tables keep one segment per
    (component, image)."""
    rng = np.random.default_rng(n)
    coefs = [_coefs(rng, n) for _ in range(3)]
    one = _tables(rng, 3, 8)
    tabs = [[one[c]] * n for c in range(3)]
    shared = {}
    got = _run(coefs, tabs, [8, 4, 4], shared)
    for c, scale in enumerate([8, 4, 4]):
        alone = [_run([coefs[c][i:i + 1]], [[one[c]]], [scale])[0][0]
                 for i in range(n)]
        assert torch.equal(got[c], torch.stack(alone))
    tensors = [torch.from_numpy(c) for c in coefs]
    qs = [[shared[one[c].tobytes()]] * n for c in range(3)]
    outs = [torch.empty((n, BLOCKS, s * s), dtype=torch.uint8)
            for s in (8, 4, 4)]
    segs = _segments(tensors, qs, outs, [8, 4, 4])
    assert [s[3] for s in segs] == [n * BLOCKS] * 3
    own = [[torch.from_numpy(t.astype(np.int32))
            for t in _tables(rng, n, 8)] for _ in range(3)]
    assert len(_segments(tensors, own, outs, [8, 4, 4])) == 3 * n


def test_meta_tensors_raise():
    coef = torch.empty((1, 4, 64), dtype=torch.int16, device="meta")
    q = torch.empty(64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no E1 implementation"):
        idct_exact_batch([coef], [[q]], [8])


@pytest.mark.parametrize("bad", ["dtype", "device", "shape", "scale"])
def test_rejected_inputs(bad):
    coef = torch.zeros((2, 4, 64), dtype=torch.int16)
    q = torch.ones(64, dtype=torch.int32)
    qs, scale = [q, q], 8
    if bad == "dtype":
        qs = [q.to(torch.int64)] * 2
    elif bad == "device":
        qs = [q.to("meta")] * 2
    elif bad == "shape":
        qs = [q]
    else:
        scale = 3
    with pytest.raises((TypeError, ValueError)):
        idct_exact_batch([coef], [qs], [scale])


def test_segments_stop_at_the_images():
    """A table list longer than N makes no segment past the N images'
    coefficients and outputs, and K2's wrapper refuses a folded list whose
    length is not N."""
    coef = torch.zeros((2, 4, 64), dtype=torch.int16)
    out = torch.empty((2, 4, 64), dtype=torch.uint8)
    own = [torch.ones(64, dtype=torch.int32) for _ in range(3)]
    segs = _segments([coef], [own], [out], [8])
    assert [s[3] for s in segs] == [4, 4]
    assert segs[-1][0] + 4 * 128 == coef.data_ptr() + coef.numel() * 2
    assert segs[-1][2] + 4 * 64 == out.data_ptr() + out.numel()
    q = torch.ones(64)
    basis = torch.zeros((64, 64))
    with pytest.raises(ValueError, match="N bases"):
        kernels.dequant_idct_batch([coef], [[q, q]], [basis], [8],
                                   [[basis, basis, basis]])


def _counting(monkeypatch, module) -> list:
    """Count the calls of `module.idct_exact_batch`; returns the list of
    their segment counts (components x images)."""
    calls = []

    def spy(coefs, qts, scales):
        calls.append(sum(len(qc) for qc in qts))
        return idct_exact_batch(coefs, qts, scales)

    monkeypatch.setattr(module, "idct_exact_batch", spy)
    return calls


@pytest.mark.parametrize("path", ["batch 1", "group of 3", "hetero group",
                                  "prefix group", "Decoder", "service"])
def test_planes_at_exact_call_the_wrapper_once_per_group(monkeypatch, path):
    from jpeg_decoder_tpu_torch.host.decoder import Decoder as HostDecoder
    from jpeg_decoder_tpu_torch.ops import pipeline

    small = fixture("small_444.jpg")
    mixed = [fixture("mixed_320x240.jpg"), fixture("mixed_448x448.jpg")]
    stream, batch, kw, groups = {
        "batch 1": ([small], 1, {}, 1),
        "group of 3": ([small] * 3, 3, {}, 1),
        "hetero group": (mixed, 2, {}, 2),          # one call per plan
        "prefix group": ([small] * 3, 3, {"interchange": "prefix"}, 1),
        "Decoder": ([small], None, {}, 1),
        "service": ([small, fixture("small_gray.jpg")], None, {}, 2),
    }[path]
    calls = _counting(monkeypatch, pipeline)
    if path == "Decoder":
        out = [np.frombuffer(jt.Decoder(small, device="cpu",
                                        precision="exact").decode(),
                             np.uint8)]
        gold = [np.frombuffer(HostDecoder(small, precision="exact")
                              .decode(), np.uint8)]
    elif path == "service":
        out = jt.BatchDecodeService(device="cpu").decode_all(stream)
        gold = [HostDecoder(d, backend="numpy", precision="exact")
                .decode_array() for d in stream]
    else:
        with jt.DeviceStreamDecoder(device="cpu", precision="exact",
                                    host_threads=1, **kw) as dec:
            out = [o.numpy() for o in dec.decode_stream(stream,
                                                         batch_size=batch)]
        gold = [HostDecoder(d, backend="numpy", precision="exact")
                .decode_array() for d in stream]
    assert len(calls) == groups
    for got, want in zip(out, gold):
        assert np.array_equal(np.asarray(got).reshape(-1),
                              np.asarray(want).reshape(-1))


@pytest.mark.parametrize("level", ["bits", "stores"])
def test_stripes_call_the_wrapper_once_per_stripe(monkeypatch, level):
    from jpeg_decoder_tpu_torch.host.decoder import Decoder as HostDecoder
    from jpeg_decoder_tpu_torch.ops import pipeline

    data, n = stripe_case("420")
    calls = _counting(monkeypatch, pipeline)
    mesh = make_mesh({"stripe": n}, ["cpu"] * n)
    if level == "bits":
        got = decode_bits_striped(jt.stage_host_bits(data), mesh).numpy()
        gold = HostDecoder(data, backend="numpy").decode_array()
    else:
        geometry, stores, qts, mcu_rows, golden = _stores(data)
        got = decode_striped(geometry, stores, qts, mesh, mcu_rows)
        gold = np.frombuffer(golden, np.uint8)
    assert calls == [3] * n             # 3 components of one image each
    assert np.array_equal(got.reshape(-1), np.asarray(gold).reshape(-1))


# The kernel's named constants and the host copy's values (the rest are
# the reference's own expressions, `_idct4x4`, `_idct2x2`, `_idct1x1`).
CONSTANTS = {
    "kC0_541": host_idct._C0_541, "kCM1_847": host_idct._CM1_847,
    "kC0_765": host_idct._C0_765, "kC1_175": host_idct._C1_175,
    "kC0_298": host_idct._C0_298, "kC2_053": host_idct._C2_053,
    "kC3_072": host_idct._C3_072, "kC1_501": host_idct._C1_501,
    "kCM0_899": host_idct._CM0_899, "kCM2_562": host_idct._CM2_562,
    "kCM1_961": host_idct._CM1_961, "kCM0_390": host_idct._CM0_390,
    "kXScaleCol": 512, "kXScaleRow": host_idct._X_SCALE_ROW,
    "kRound4": 512, "kBias4": (1 << 16) + (128 << 17),
    "kBias2": (1 << 2) + (128 << 3), "kDc1": 1024,
}


def test_kernel_constants_equal_the_host_copy():
    """Every `constexpr int32_t` of the kernel source is listed here and
    equals its value in `host/ops/idct.py`; each is used."""
    src = CU.read_text()
    found = dict(re.findall(r"constexpr int32_t (k\w+) = (-?\d+);", src))
    assert {k: int(v) for k, v in found.items()} == CONSTANTS
    for name in CONSTANTS:
        assert len(re.findall(rf"\b{name}\b", src)) >= 2, name

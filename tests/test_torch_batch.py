"""Batched dispatch of the PyTorch port, `DeviceStreamDecoder.decode_stream(
batch_size=N)`, on the CPU: its grouping rules and building blocks, against
its own one-image decode (every layout, precision and interchange against
the JAX package: tests/test_torch_batch_jax.py). Tolerance: bit-equal
throughout.

- Spies count the device steps: one K1 sweep per same-key group, one sweep
  plus one reconstruction per plan for mixed sizes, one L1 call per
  predictor-6 group; a group past K1's block limit splits.
- The grouping rules: the reference's size-aware hetero key
  (`tests/test_pallas_decode.py::test_hetero_grouping_is_size_aware`),
  JPEG_TPU_HETERO_BITS (in a subprocess: tests do not set JPEG_TPU_*
  in-process), on_error="none" inside a batch
  (`tests/test_jax_backend.py::test_stream_error_isolation`).
- The batched building blocks, each equal to its per-image calls: K2's
  plain segment table, K3's plain image axis, assembly, the exact IDCT
  with per-image tables, upsampling, the prefix rebuild and the lossless
  closed forms.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu.models.stream import \
    DeviceStreamDecoder as JaxStreamDecoder
from jpeg_decoder_tpu_torch import DeviceStreamDecoder, stage_host_bits
import jpeg_decoder_tpu_torch.models.stream as port_stream
import jpeg_decoder_tpu_torch.ops.predictors as port_predictors
from jpeg_decoder_tpu_torch.params import DeviceParams

from torch_inputs import TAIL_CASES, fixture, synth_jpeg, tail_planes

REPO = Path(__file__).resolve().parent.parent
BAD = b"\xff\xd8 definitely not a jpeg"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread each, so that the
    test workers sharing the cores do not oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stream() -> list:
    """Two 4:2:0 sizes of one encoder (one hetero group), two grayscale
    images (one same-key group) and one 4:2:2 image (a group of one)."""
    return [synth_jpeg(64, 48, seed=1), synth_jpeg(64, 48, seed=2),
            synth_jpeg(48, 64, seed=3), synth_jpeg(40, 24, seed=4,
                                                   mode="L"),
            synth_jpeg(40, 24, seed=5, mode="L"),
            synth_jpeg(48, 32, seed=6, subsampling=1)]


def _sof3(predictor: int, ncomp: int, precision: int, seed: int) -> bytes:
    from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

    pt = 1 if predictor == 7 else 0
    return sof3_jpeg(sof3_samples(13, 19, ncomp, precision, pt, seed=seed),
                     predictor, pt, precision)


def _decode(stream, batch_size=1, **kw) -> list:
    with DeviceStreamDecoder(device="cpu", host_threads=2, **kw) as dec:
        return dec.decode_stream(stream, batch_size=batch_size)


def _assert_bit_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        assert torch.equal(g, w), i


class _Spies:
    def __init__(self, monkeypatch):
        self.k1 = self.recon = self.l1 = 0
        k1, recon = port_stream.decode_chunks, \
            port_stream.DeviceStreamDecoder._reconstruct
        l1 = port_predictors.lossless_recur

        def spy_k1(*a):
            self.k1 += 1
            return k1(*a)

        def spy_recon(dec, *a):
            self.recon += 1
            return recon(dec, *a)

        def spy_l1(*a):
            self.l1 += 1
            return l1(*a)

        monkeypatch.setattr(port_stream, "decode_chunks", spy_k1)
        monkeypatch.setattr(port_stream.DeviceStreamDecoder, "_reconstruct",
                            spy_recon)
        monkeypatch.setattr(port_predictors, "lossless_recur", spy_l1)


def test_one_k1_sweep_per_same_key_group(monkeypatch):
    stream = [fixture("small_444.jpg")] * 3 + [fixture("small_dri.jpg")] * 2
    want = _decode(stream, 1)
    spies = _Spies(monkeypatch)
    got = _decode(stream, 2)
    _assert_bit_equal(got, want)
    assert (spies.k1, spies.recon) == (3, 3)     # 2 + 1 small_444, 2 dri


def test_mixed_sizes_one_sweep_and_one_reconstruct_per_plan(monkeypatch):
    sizes = [(64, 48), (48, 64), (64, 48), (56, 40)]
    stream = [synth_jpeg(w, h, seed=10 + i) for i, (w, h) in
              enumerate(sizes)]
    want = _decode(stream, 1)
    spies = _Spies(monkeypatch)
    got = _decode(stream, 4)
    _assert_bit_equal(got, want)
    assert (spies.k1, spies.recon) == (1, 3)


def test_one_l1_launch_per_predictor_6_group(monkeypatch):
    stream = [_sof3(6, 3, 16, s) for s in range(6)]
    want = _decode(stream, 1)
    spies = _Spies(monkeypatch)
    got = _decode(stream, 3)
    _assert_bit_equal(got, want)
    assert spies.l1 == 2


def test_group_past_k1_block_limit_splits(monkeypatch):
    stream = [fixture("small_gray.jpg")] * 3
    want = _decode(stream, 1)
    nb = stage_host_bits(stream[0]).scans[0].scan.plan.n_blocks
    monkeypatch.setattr(port_stream, "K1_MAX_BLOCKS", 2 * nb)
    spies = _Spies(monkeypatch)
    _assert_bit_equal(_decode(stream, 3), want)
    assert spies.k1 == 2


def test_hetero_grouping_is_size_aware(monkeypatch):
    """The reference's test: above the hetero threshold an image groups on
    the exact key, below it on the hetero key."""
    small_blob = synth_jpeg(320, 256, seed=11)
    big_blob = synth_jpeg(1024, 768, seed=12)
    small, big = stage_host_bits(small_blob), stage_host_bits(big_blob)
    assert small.mpix <= 0.25 < big.mpix
    routed = []
    real = port_stream._bits_hetero_key

    def spy_hetero(st):
        routed.append(st.mpix)
        return real(st)

    monkeypatch.setattr(port_stream, "_bits_hetero_key", spy_hetero)
    monkeypatch.setattr(port_stream.DeviceStreamDecoder, "_decode_group",
                        lambda self, kind, group: [None] * len(group))
    with DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
        outs = dec.decode_stream([small_blob, big_blob], batch_size=4)
    assert len(outs) == 2
    assert routed == [small.mpix]


_ENV_SCRIPT = r"""
import os, sys
sys.path.insert(0, "tests")
from torch_inputs import synth_jpeg
import jpeg_decoder_tpu_torch.models.stream as sm
stream = [synth_jpeg(64, 48, seed=1), synth_jpeg(48, 64, seed=2),
          synth_jpeg(64, 48, seed=3)]
sweeps = []
real = sm.decode_chunks
sm.decode_chunks = lambda *a: sweeps.append(1) or real(*a)
for value in sys.argv[1:]:
    os.environ["JPEG_TPU_HETERO_BITS"] = value
    sweeps.clear()
    with sm.DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
        try:
            dec.decode_stream(stream, batch_size=4)
            print(value, "sweeps", len(sweeps))
        except ValueError as e:
            print(value, "raised", e)
"""
HETERO_VALUES = {"0": "sweeps 3", "1": "sweeps 1", "0.001": "sweeps 3",
                 "auto": "sweeps 1"}


@pytest.fixture(scope="module")
def hetero_runs() -> dict:
    """One subprocess (tests set no JPEG_TPU_* variable in-process) decodes
    two sizes of one encoder at batch 4 under each JPEG_TPU_HETERO_BITS
    value: value -> what it printed."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JPEG_TPU_HETERO_BITS")}
    res = subprocess.run([sys.executable, "-c", _ENV_SCRIPT,
                          *HETERO_VALUES], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    return dict(line.split(" ", 1) for line in res.stdout.splitlines())


@pytest.mark.parametrize("value", list(HETERO_VALUES))
def test_hetero_threshold_from_the_environment(hetero_runs, value):
    """'' / '1' merge sizes of at most 0.25 Mpix into one sweep, '0' keeps
    each size apart, a number is the threshold, 'auto' follows the link
    monitor, which with no observation reads a healthy link (0.25), as the
    reference's does."""
    assert hetero_runs[value].startswith(HETERO_VALUES[value])


@pytest.mark.parametrize("interchange", ["bits", "prefix"])
def test_on_error_none_inside_a_batch(interchange):
    good = fixture("small_444.jpg")
    with DeviceStreamDecoder(device="cpu", host_threads=2,
                             interchange=interchange) as dec:
        outs = dec.decode_stream([good, BAD, good, good], batch_size=4,
                                 on_error="none")
        single = dec.decode_stream([good])[0]
    assert [o is None for o in outs] == [False, True, False, False]
    for img in (outs[0], outs[2], outs[3]):
        assert torch.equal(img, single)
    ref = JaxStreamDecoder(host_threads=2, interchange="prefix") \
        .decode_stream([good, BAD, good, good], batch_size=4,
                       on_error="none")
    assert [r is None for r in ref] == [o is None for o in outs]


@pytest.mark.parametrize("scale", [8, 4, 2, 1])
def test_k2_plain_segment_table_equals_per_image_calls(scale):
    from jpeg_decoder_tpu_torch.ops.kernels import (dequant_idct_batch,
                                                    dequant_idct_multi)

    params = DeviceParams("cpu")
    rng = np.random.default_rng(scale)
    n, blocks = 5, (37, 11, 11)
    coefs = [torch.from_numpy(rng.integers(-1024, 1024, (n, b, 64))
                              .astype(np.int16)) for b in blocks]
    tables = [[rng.integers(1, 60, 64).astype(np.uint16) for _ in blocks]
              for _ in range(n)]
    tables[1] = tables[0]             # neighbours that share their tables
    qs = [[params.qt(tables[i][c]) for i in range(n)]
          for c in range(len(blocks))]
    bases = [params.basis(scale)] * len(blocks)
    got = dequant_idct_batch(coefs, qs, bases, [scale] * len(blocks))
    for i in range(n):
        want = dequant_idct_multi([c[i] for c in coefs],
                                  [q[i] for q in qs], bases,
                                  [scale] * len(blocks))
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)


@pytest.mark.parametrize("name", ["420_odd", "422", "444", "ycck_420",
                                  "cmyk_h2v2_on_3"])
def test_k3_plain_image_axis_equals_per_image_calls(name):
    from jpeg_decoder_tpu_torch.ops.kernels import fused_tail

    modes, transform, out_h, out_w, chroma = TAIL_CASES[name]
    per_image = [[torch.from_numpy(p) for p in tail_planes(name, seed)]
                 for seed in range(3)]
    stacked = [torch.stack(ps) for ps in zip(*per_image)]
    got = fused_tail(stacked, modes, chroma, transform, out_h, out_w)
    assert tuple(got.shape) == (3, len(modes), out_h, out_w)
    for i, planes in enumerate(per_image):
        assert torch.equal(got[i], fused_tail(planes, modes, chroma,
                                              transform, out_h, out_w))


@pytest.mark.parametrize("name", ["small_dri.jpg", "small_cmyk_420.jpg"])
@pytest.mark.parametrize("general", [False, True])
def test_batched_assembly_equals_per_image(name, general):
    """DC sums restart at every image: image 2's DC is not offset by image
    1's last."""
    from jpeg_decoder_tpu_torch.entropy.assemble import (GeneralMaps,
                                                         assemble_general,
                                                         assemble_structured)

    (st,) = stage_host_bits(fixture(name)).scans
    plan = st.scan.plan
    rng = np.random.default_rng(len(name))
    nat = torch.from_numpy(rng.integers(-900, 900, (3, plan.n_blocks, 64))
                           .astype(np.int16))
    if general:
        maps = GeneralMaps(plan, "cpu")
        got = assemble_general(nat, maps)
        want = [assemble_general(x, maps) for x in nat]
    else:
        got = assemble_structured(nat, plan)
        want = [assemble_structured(x, plan) for x in nat]
    for c, store in enumerate(got):
        assert store.is_contiguous()
        for i in range(3):
            assert torch.equal(store[i], want[i][c])


@pytest.mark.parametrize("scale", [8, 4, 2, 1])
def test_exact_idct_per_image_tables_equals_per_image_calls(scale):
    from jpeg_decoder_tpu_torch.ops.idct import dequantize_and_idct_blocks

    rng = np.random.default_rng(20 + scale)
    coef = torch.from_numpy(rng.integers(-32768, 32768, (3, 50, 64))
                            .astype(np.int16))
    q = torch.from_numpy(rng.integers(1, 65536, (3, 64)).astype(np.int32))
    got = dequantize_and_idct_blocks(coef, q, scale)
    assert tuple(got.shape) == (3, 50, scale, scale)
    for i in range(3):
        assert torch.equal(got[i], dequantize_and_idct_blocks(coef[i], q[i],
                                                              scale))


@pytest.mark.parametrize("mode", ["h1v1", "h2v1", "h1v2", "h2v2", "generic"])
def test_batched_upsampling_equals_per_plane(mode):
    from jpeg_decoder_tpu_torch.ops.upsample import upsample_component

    rng = np.random.default_rng(len(mode))
    planes = torch.from_numpy(rng.integers(0, 256, (3, 24, 32))
                              .astype(np.uint8))
    args = (mode, 29, 21, 41, 57, 3, 2)   # width, height, rows, cols, h, v
    got = upsample_component(planes, *args)
    for i in range(3):
        assert torch.equal(got[i], upsample_component(planes[i], *args))


@pytest.mark.parametrize("predictor", [0, 1, 2, 3, 4])
def test_lossless_closed_forms_vectorised_over_planes(predictor):
    from jpeg_decoder_tpu_torch.host.parser import Predictor
    from jpeg_decoder_tpu_torch.ops.predictors import \
        reconstruct_lossless_device

    rng = np.random.default_rng(predictor)
    d = torch.from_numpy(rng.integers(0, 65536, (4, 9, 7)).astype(np.int32))
    got = reconstruct_lossless_device(d, Predictor(predictor), 0, 16, False)
    for i in range(4):
        assert torch.equal(got[i], reconstruct_lossless_device(
            d[i], Predictor(predictor), 0, 16, False))


def test_prefix_group_rebuild_equals_per_image():
    from jpeg_decoder_tpu_torch.host.staging import stage_host

    stream = [synth_jpeg(64, 48, seed=s) for s in (1, 2, 3)]
    staged = [stage_host(b) for b in stream]
    with DeviceStreamDecoder(device="cpu", host_threads=1,
                             interchange="prefix") as dec:
        wires = dec._put_recorded(port_stream._prefix_wire(staged, 3))
        group = port_stream.prefix_stores(staged[0].geometry, *wires)
        for i, st in enumerate(staged):
            one = port_stream.prefix_stores(st.geometry,
                                           *dec._wire_tensors(st))
            for g, o in zip(group, one):
                assert torch.equal(g[i], o[0])

"""The PyTorch port's main path as a whole:
`jpeg_decoder_tpu_torch.DeviceStreamDecoder(device="cpu").decode_stream`
against the JAX package's `DeviceStreamDecoder(interchange="bits",
precision="fast")` on CPU JAX.

Tolerances:
- pixels: |diff| <= 3. Both sides run an fp32 IDCT whose outputs may
  differ by 1 (summation order), and color conversion scales a chroma
  difference of 1 by up to 1.772, so 1 + 1.772 rounds to at most 3;
- coefficient stores: bit-equal to the host oracle;
- the port's planar layouts against its own interleaved output, permuted:
  bit-equal (the same IDCT, and integer math after it);
- lossless: bit-equal.
Progressive, lossless and quirk streams decode (tests/
test_torch_stream_paths.py and test_torch_lossless.py hold them in full),
and so does batch_size > 1 (tests/test_torch_batch.py); options the port
lacks raise a typed error naming what is missing.
"""

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu.models.stream import \
    DeviceStreamDecoder as JaxStreamDecoder
from jpeg_decoder_tpu_torch import DeviceStreamDecoder, stage_host_bits
from jpeg_decoder_tpu_torch.entropy.assemble import assemble_nat
from jpeg_decoder_tpu_torch.entropy.chunk_decode import (decode_chunks,
                                                         unpack_delta)
from jpeg_decoder_tpu_torch.params import scan_tables

from torch_inputs import (FIXTURE_DIR, SMALL_FIXTURES, fixture, oracle_stores,
                          synth_jpeg)

SLICE_INPUTS = {
    **{name: (lambda n=name: fixture(n)) for name in SMALL_FIXTURES},
    "synth_640x480_420": lambda: synth_jpeg(640, 480, seed=21),
    "synth_320x240_422": lambda: synth_jpeg(320, 240, seed=22, subsampling=1),
    "synth_200x152_444_dri": lambda: synth_jpeg(200, 152, seed=23,
                                                subsampling=0, restart_rows=2),
}


PLANAR_INPUTS = SMALL_FIXTURES + ("synth_320x240_422",)


def _pixel_diff(port, ref):
    assert port.device.type == "cpu" and port.dtype == torch.uint8
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    d = np.abs(port.numpy().astype(np.int32) - ref.astype(np.int32))
    return int(d.max()), int((d > 0).sum())


def test_slice_within_3_of_jax_bits_path():
    names = list(SLICE_INPUTS)
    data = [SLICE_INPUTS[n]() for n in names]
    with DeviceStreamDecoder(device="cpu", host_threads=2) as dec:
        port = dec.decode_stream(data)
    ref = JaxStreamDecoder(host_threads=2, precision="fast",
                           interchange="bits").decode_stream(data)
    for name, p, r in zip(names, port, ref):
        worst, count = _pixel_diff(p, r)
        print(f"{name}: max |diff| {worst}, {count} of {p.numel()} differ")
        assert worst <= 3, (name, worst, count)


def test_slice_scaled_within_3_of_jax():
    data = synth_jpeg(640, 480, seed=24)
    for scale_to in ((320, 240), (160, 120), (80, 60)):
        with DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
            port = dec.decode_stream([data], scale_to=scale_to)[0]
        ref = JaxStreamDecoder(host_threads=1, precision="fast",
                               interchange="bits").decode_stream(
                                   [data], scale_to=scale_to)[0]
        worst, count = _pixel_diff(port, ref)
        assert port.shape[:2] == (scale_to[1], scale_to[0])
        assert worst <= 3, (scale_to, worst, count)


@pytest.mark.parametrize("layout", ["planar", "planar-pallas"])
def test_planar_layouts_within_3_of_jax_bits_path(layout):
    data = [SLICE_INPUTS[n]() for n in PLANAR_INPUTS]
    with DeviceStreamDecoder(device="cpu", host_threads=2,
                             layout=layout) as dec:
        port = dec.decode_stream(data)
    ref = JaxStreamDecoder(host_threads=2, precision="fast",
                           interchange="bits",
                           layout=layout).decode_stream(data)
    for name, p, r in zip(PLANAR_INPUTS, port, ref):
        worst, count = _pixel_diff(p, r)
        print(f"{layout} {name}: max |diff| {worst}, {count} differ")
        assert worst <= 3, (layout, name, worst, count)


@pytest.mark.parametrize("layout", ["planar", "planar-pallas"])
def test_planar_layouts_bit_equal_to_interleaved_permuted(layout):
    data = [SLICE_INPUTS[n]() for n in PLANAR_INPUTS]
    with DeviceStreamDecoder(device="cpu", host_threads=2) as dec:
        interleaved = dec.decode_stream(data)
    with DeviceStreamDecoder(device="cpu", host_threads=2,
                             layout=layout) as dec:
        planar = dec.decode_stream(data)
        effective = [dec._effective_layout(dec.stage(d).geometry)
                     for d in data]
    for name, p, i in zip(PLANAR_INPUTS, planar, interleaved):
        want = i.permute(2, 0, 1) if i.dim() == 3 else i
        assert p.dim() == 2 or p.is_contiguous(), name
        torch.testing.assert_close(p, want, rtol=0, atol=0, msg=name)
    if layout == "planar-pallas":         # every input here has a K3 tail
        assert effective == ["planar-pallas"] * len(data)


@pytest.mark.parametrize("name", SMALL_FIXTURES)
def test_slice_stores_bit_equal_to_oracle(name):
    data = fixture(name)
    staged = stage_host_bits(data)
    oracle = oracle_stores(data)
    for st in staged.scans:
        dm = torch.from_numpy(st.dm)
        ab, base = unpack_delta(dm)
        nat = decode_chunks(torch.from_numpy(st.words), dm, ab, base,
                            scan_tables(st.scan, "cpu"), st.s_max,
                            st.scan.plan.n_blocks)
        stores = assemble_nat(nat, st.scan.plan)
        for pos, comp_i in st.kept:
            np.testing.assert_array_equal(stores[pos].numpy().reshape(-1),
                                          oracle[comp_i])


def _lossless_jpeg():
    from test_lossless_restart_order import _build_lossless_jpeg

    rng = np.random.default_rng(31)
    return _build_lossless_jpeg(rng.integers(-7, 8, (6, 5)), dri=0)


# Streams the baseline-only port refused, each now decoded. The ids are the
# ones the earlier raise cases had.
@pytest.mark.parametrize("kind", [
    pytest.param("progressive", id="progressive-progressive"),
    pytest.param("lossless", id="lossless-lossless"),
    pytest.param("quirk", id="quirk-host entropy semantics"),
])
def test_streams_outside_the_slice_raise(kind):
    """Progressive (transcoded), lossless (device predictors) and a quirk
    stream the prescan defers (host decode + transcode) decode through
    `decode_stream` and match the JAX `DeviceStreamDecoder`: bit-equal for
    lossless, within 3 at fast precision otherwise. The malformed
    restart-underrun fixture raises the host's FormatError on both."""
    from torch_inputs import quirk_jpeg
    from jpeg_decoder_tpu_torch.host.errors import FormatError

    data = {
        "progressive": lambda: synth_jpeg(64, 48, seed=32, progressive=True),
        "lossless": _lossless_jpeg,
        "quirk": lambda: quirk_jpeg(1),
    }[kind]()
    staged = stage_host_bits(data)
    assert type(staged).__name__ == ("StagedLossless" if kind == "lossless"
                                     else "StagedBits")
    with DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
        port = dec.decode_stream([data])[0]
    ref = JaxStreamDecoder(host_threads=1, precision="fast",
                           interchange="bits").decode_stream([data])[0]
    worst, count = _pixel_diff(port, ref)
    assert worst <= (0 if kind == "lossless" else 3), (kind, worst, count)
    if kind == "quirk":
        bad = (FIXTURE_DIR.parent / "restart_underrun_prescan.jpg") \
            .read_bytes()
        with DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
            with pytest.raises(FormatError, match="no marker found"):
                dec.decode_stream([bad])


def test_options_outside_the_slice_raise():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-CUDA error cannot occur")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceStreamDecoder(device="cuda")
    for kw in ({"precision": "exact"}, {"interchange": "prefix"}):
        DeviceStreamDecoder(device="cpu", **kw).close()     # both ported
    for kw, what in (({"layout": "planar-xla"}, "layout"),
                     ({"precision": "bf16"}, "precision"),
                     ({"interchange": "coo"}, "interchange")):
        with pytest.raises(ValueError, match=what):
            DeviceStreamDecoder(device="cpu", **kw)
    with DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
        # batch_size > 1, once refused, decodes: each image bit-equal to
        # its one-image decode (tests/test_torch_batch.py holds the rest).
        gray = fixture("small_gray.jpg")
        single = dec.decode_stream([gray])[0]
        batched = dec.decode_stream([gray, gray], batch_size=2)
        assert len(batched) == 2
        for img in batched:
            torch.testing.assert_close(img, single, rtol=0, atol=0)
        with pytest.raises(RuntimeError, match="CUDA"):
            dec.device_resident_rate(gray)

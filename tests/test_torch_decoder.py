"""The port's front end, `jpeg_decoder_tpu_torch.Decoder(backend="torch",
device="cpu")`, against the JAX package's `Decoder(backend="jax")` (CPU
JAX) and `Decoder(backend="numpy")` on the same bytes.

Tolerances:
- precision "exact": bit-equal (integer IDCT, upsampling and color on both
  sides), fixtures, progressive and scaled decodes alike;
- precision "fast": |diff| <= 3 against the exact decode and against the
  JAX package's fast decode. Each side runs an fp32 IDCT whose pixels may
  differ by 1 from the exact one (rounding, summation order), and color
  conversion scales a chroma difference of 1 by up to 1.772: 1 + 1.772
  rounds to at most 3 (the reference's fast-tier contract);
- lossless (SOF3): bit-equal, every predictor 1-7 at point transforms 0
  and 2, 1 and 3 components, 8 and 16 bits, and a stream whose restart
  interval triggers the reference's `restart_all` quirk;
- metadata and typed errors: equal to the reference's (the port's error
  classes are its host copy's, so they match by name and message).
The "auto" backend follows the reference's 128 x 128 rule, checked on both
sides of it by a spy on the device reconstruction.
"""

import numpy as np
import pytest

import jpeg_decoder_tpu as ref
import jpeg_decoder_tpu_torch as jt
import jpeg_decoder_tpu_torch.decoder as port_decoder
from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

from torch_inputs import SMALL_FIXTURES, fixture, synth_jpeg

FIXTURES = SMALL_FIXTURES + ("small_422_progressive.jpg",)
FAST_TOL = 3


def _port(data, precision="exact", backend="torch"):
    return jt.Decoder(data, backend=backend, precision=precision,
                      device="cpu")


def _arr(raw: bytes, d) -> np.ndarray:
    info = d.info()
    n = info.pixel_format.pixel_bytes()
    return np.frombuffer(raw, np.uint8).reshape(info.height, info.width * n) \
        .astype(np.int32)


@pytest.mark.parametrize("name", FIXTURES)
def test_exact_bit_equal_to_jax_and_numpy(name):
    data = fixture(name)
    got = _port(data).decode()
    assert got == ref.Decoder(data, backend="jax").decode()
    assert got == ref.Decoder(data, backend="numpy").decode()


@pytest.mark.parametrize("name", FIXTURES)
def test_fast_within_three(name):
    data = fixture(name)
    d = _port(data, "fast")
    got = _arr(d.decode(), d)
    exact = _arr(ref.Decoder(data, backend="numpy").decode(), d)
    jax_fast = _arr(ref.Decoder(data, backend="jax", precision="fast")
                    .decode(), d)
    assert np.abs(got - exact).max() <= FAST_TOL
    assert np.abs(got - jax_fast).max() <= FAST_TOL


@pytest.fixture(scope="module")
def scaled_source() -> bytes:
    return synth_jpeg(120, 88, seed=31)          # 4:2:0


@pytest.mark.parametrize("size", [(60, 44), (30, 22), (15, 11)])
def test_scaled_bit_equal(scaled_source, size):
    """IDCT-domain scaling to 1/2, 1/4 and 1/8 (the reference's
    test_jax_matches_numpy_scaled)."""
    outs = []
    for dec in (_port(scaled_source),
                ref.Decoder(scaled_source, backend="jax"),
                ref.Decoder(scaled_source, backend="numpy")):
        assert dec.scale(*size) == size
        outs.append(dec.decode())
    assert outs[0] == outs[1] == outs[2]


SOF3_CASES = [(p, pt, c, bits) for p in range(1, 8) for pt in (0, 2)
              for c in (1, 3) for bits in (8, 16)]


@pytest.mark.parametrize("predictor,pt,ncomp,bits", SOF3_CASES,
                         ids=[f"p{p}-pt{pt}-c{c}-{b}bit"
                              for p, pt, c, b in SOF3_CASES])
def test_lossless_bit_equal(predictor, pt, ncomp, bits):
    samples = sof3_samples(13, 17, ncomp, bits, pt, seed=predictor * 10 + pt)
    data = sof3_jpeg(samples, predictor, pt, bits)
    got = _port(data).decode()
    assert got == ref.Decoder(data, backend="jax").decode()
    assert got == ref.Decoder(data, backend="numpy").decode()
    want = (samples.astype(np.uint16) << pt).reshape(-1)
    assert got == (want.astype(np.uint8) if bits == 8 else want).tobytes()


@pytest.mark.parametrize("predictor", [1, 2, 6])
def test_lossless_restart_all_bit_equal(predictor, monkeypatch):
    """A restart interval of 1 with every sample its own interval: the
    reference's stale restart flag (`restart_all`) is set, Ra chains
    anyway and the other predictors take the default prediction."""
    from jpeg_decoder_tpu_torch.host.staging import stage_host_lossless
    from test_lossless_restart_order import _build_lossless_jpeg

    diffs = np.random.default_rng(5).integers(-7, 8, (6, 7))
    data = _build_lossless_jpeg(diffs, dri=1, predictor=predictor)
    assert stage_host_lossless(data).restart_all
    calls = []
    real = port_decoder.reconstruct_lossless_device
    monkeypatch.setattr(port_decoder, "reconstruct_lossless_device",
                        lambda *a: calls.append(a[4]) or real(*a))
    got = _port(data).decode()
    assert calls == [True]
    assert got == ref.Decoder(data, backend="jax").decode()
    assert got == ref.Decoder(data, backend="numpy").decode()


def test_lossless_routes_as_the_reference(monkeypatch):
    """Per component: Ra with a point transform on the host oracle, the
    closed forms for what `device_supported` names, the wavefront (L1)
    otherwise; one device call per component."""
    seen = []
    for name in ("reconstruct_lossless_device",
                 "reconstruct_lossless_wavefront"):
        real = getattr(port_decoder, name)
        monkeypatch.setattr(port_decoder, name,
                            lambda *a, _n=name, _r=real:
                            seen.append(_n) or _r(*a))
    for predictor, pt, want in ((1, 2, []),
                                (2, 0, ["reconstruct_lossless_device"] * 3),
                                (6, 0, ["reconstruct_lossless_wavefront"] * 3),
                                (2, 2,
                                 ["reconstruct_lossless_wavefront"] * 3)):
        seen.clear()
        data = sof3_jpeg(sof3_samples(9, 11, 3, 8, pt, seed=3), predictor,
                         pt, 8)
        _port(data).decode()
        assert seen == want, (predictor, pt)


@pytest.mark.parametrize("side,backend", [(128, "numpy"), (136, "torch")])
def test_auto_follows_the_128_square_rule(side, backend, monkeypatch):
    data = synth_jpeg(side, 128, seed=side)
    calls = []
    real = port_decoder.reconstruct_on_device
    monkeypatch.setattr(port_decoder, "reconstruct_on_device",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = _port(data, backend="auto").decode()
    assert ("torch" if calls else "numpy") == backend
    r = ref.Decoder(data, backend="auto")
    r.read_info()
    assert {"jax": "torch"}.get(r._select_backend(r.frame), "numpy") \
        == backend
    assert got == ref.Decoder(data, backend="numpy").decode()


def test_auto_reconstructs_lossless_on_the_host(monkeypatch):
    """As the reference's: only backend "torch" (there "jax") sends a
    lossless frame to the device, whatever its size."""
    data = sof3_jpeg(sof3_samples(140, 140, 1, 8, 0, seed=4), 6, 0, 8)
    monkeypatch.setattr(port_decoder, "reconstruct_lossless_wavefront",
                        None)
    assert _port(data, backend="auto").decode() \
        == ref.Decoder(data, backend="numpy").decode()


@pytest.mark.parametrize("name", FIXTURES)
def test_metadata_equal_to_the_reference(name):
    data = fixture(name)
    port, want = _port(data), ref.Decoder(data)
    assert port.info() is None and want.info() is None
    port.read_info()
    want.read_info()
    a, b = port.info(), want.info()
    assert (a.width, a.height, a.pixel_format.value,
            a.coding_process.name) == (b.width, b.height,
                                       b.pixel_format.value,
                                       b.coding_process.name)
    for getter in ("icc_profile", "exif_data", "xmp_data", "psir_data"):
        assert getattr(port, getter)() == getattr(want, getter)()
    assert (port.jfif_info() is None) == (want.jfif_info() is None)
    assert port.scale(8, 8) == want.scale(8, 8)


def _raised(make):
    try:
        make().decode()
    except Exception as e:       # compared by class name and message
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", ["garbage", "empty", "buffer_limit",
                                  "truncated"])
def test_typed_errors_equal_to_the_reference(case):
    data = fixture("small_444.jpg")
    source = {"garbage": b"\x00\x01garbage bytes", "empty": b"",
              "buffer_limit": data, "truncated": data[:300]}[case]

    def maker(cls, **kw):
        def make():
            d = cls(source, **kw)
            if case == "buffer_limit":
                d.set_max_decoding_buffer_size(100)
            return d
        return make

    got = _raised(maker(jt.Decoder, device="cpu"))
    assert got is not None
    assert got == _raised(maker(ref.Decoder, backend="jax"))
    assert issubclass(getattr(jt, got[0]), jt.JpegError)


def test_unknown_backend_and_precision_raise():
    data = fixture("small_gray.jpg")
    with pytest.raises(ValueError, match="backend"):
        jt.Decoder(data, backend="jax", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        jt.Decoder(data, precision="half", device="cpu")


def test_decode_array_and_timer():
    """decode_array returns numpy, as the reference's; the timer records
    the device backend's stages."""
    data = fixture("small_422.jpg")
    timer = jt.StageTimer()
    arr = jt.Decoder(data, device="cpu", timer=timer).decode_array()
    assert isinstance(arr, np.ndarray)
    np.testing.assert_array_equal(arr, ref.Decoder(data).decode_array())
    assert dict(timer.counts) == {"h2d_submit": 1, "device_dispatch": 1,
                                  "d2h": 1}

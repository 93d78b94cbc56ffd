"""The port's one-image stream decoder beyond the baseline fast path,
against the JAX package on CPU JAX and the host oracle:
- precision "exact": bit-equal to the JAX `DeviceStreamDecoder(precision=
  "exact", interchange="bits")` and to `Decoder(precision="exact")`, full
  size and scaled;
- progressive and quirk streams (host decode + transcode, then K1): stores
  bit-equal to the oracle, pixels bit-equal (exact) or within 3 (fast);
- transcoded stores that reach DC category 16 and AC size 15, through the
  plain K1, bit-equal;
- the three-table-pair SOF1 stream on the 12 B/chunk anchor wire (6 table
  rows): stores bit-equal to the oracle, the image equal to the unedited
  file's;
- `interchange="prefix"`: bit-equal to the bits path and to the JAX prefix
  path;
- planar-pallas runs its fp32 IDCT at either precision, as the reference's
  `reconstruct_planar_pallas` does.
Tolerance 3 at fast precision: an fp32 IDCT 1 off, times up to 1.772
through color (tests/test_torch_slice.py).
"""

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu import Decoder
from jpeg_decoder_tpu.entropy.transcode import transcode_scan
from jpeg_decoder_tpu.errors import FormatError
from jpeg_decoder_tpu.models.stream import \
    DeviceStreamDecoder as JaxStreamDecoder
from jpeg_decoder_tpu_torch import DeviceStreamDecoder, stage_host_bits
from jpeg_decoder_tpu_torch.host.errors import FormatError as PortFormatError
from jpeg_decoder_tpu_torch.entropy.assemble import assemble_nat
from jpeg_decoder_tpu_torch.entropy.chunk_decode import (decode_chunks,
                                                         unpack_delta)
from jpeg_decoder_tpu_torch.models.stream import (StagedBits, _anchor_scan,
                                                  _wire_scan)
from jpeg_decoder_tpu_torch.params import scan_tables

from torch_inputs import (FIXTURE_DIR, SMALL_FIXTURES, fixture, oracle_stores,
                          quirk_jpeg, synth_jpeg, three_table_pairs)


def _stores(st) -> list:
    """Plain K1 + assembly of one StagedScan, on the CPU."""
    words, dm = torch.from_numpy(st.words), torch.from_numpy(st.dm)
    if st.ab is None:
        ab, base = unpack_delta(dm)
    else:
        ab, base = torch.from_numpy(st.ab), torch.from_numpy(st.base)
    nat = decode_chunks(words, dm, ab, base, scan_tables(st.scan, "cpu"),
                        st.s_max, st.scan.plan.n_blocks)
    return assemble_nat(nat, st.scan.plan)


def _assert_stores_match_oracle(staged: StagedBits, data: bytes) -> None:
    oracle = oracle_stores(data)
    seen = set()
    for st in staged.scans:
        stores = _stores(st)
        for pos, comp_i in st.kept:
            np.testing.assert_array_equal(stores[pos].numpy().reshape(-1),
                                          oracle[comp_i])
            seen.add(comp_i)
    assert seen == set(range(len(oracle)))


def _decode(data, scale_to=None, **kw):
    with DeviceStreamDecoder(device="cpu", host_threads=1, **kw) as dec:
        return dec.decode_stream([data], scale_to=scale_to)[0]


def _jax(data, scale_to=None, **kw):
    return np.asarray(JaxStreamDecoder(host_threads=1, **kw).decode_stream(
        [data], scale_to=scale_to)[0])


def _exact(data, scale_to=None):
    d = Decoder(data, backend="numpy", precision="exact")
    if scale_to is not None:
        d.scale(*scale_to)
    return d.decode_array()


def _max_diff(port, ref) -> int:
    ref = np.asarray(ref)
    assert tuple(port.shape) == ref.shape
    return int(np.abs(port.numpy().astype(np.int32)
                      - ref.astype(np.int32)).max())


def test_exact_bit_equal_to_jax_and_decoder():
    data = [fixture(n) for n in SMALL_FIXTURES]
    with DeviceStreamDecoder(device="cpu", host_threads=2,
                             precision="exact") as dec:
        port = dec.decode_stream(data)
    ref = JaxStreamDecoder(host_threads=2, precision="exact",
                           interchange="bits").decode_stream(data)
    for name, d, p, r in zip(SMALL_FIXTURES, data, port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=name)
        np.testing.assert_array_equal(p.numpy(), _exact(d), err_msg=name)


@pytest.mark.parametrize("scale_to", [(101, 70), (51, 35), (26, 18)])
def test_exact_scaled_bit_equal_to_jax_and_decoder(scale_to):
    data = fixture("small_444.jpg")
    port = _decode(data, scale_to, precision="exact")
    np.testing.assert_array_equal(
        port.numpy(), _jax(data, scale_to, precision="exact",
                           interchange="bits"))
    np.testing.assert_array_equal(port.numpy(), _exact(data, scale_to))


HOST_DECODED = {
    "progressive_420": lambda: synth_jpeg(64, 48, seed=32, progressive=True),
    "progressive_422": lambda: fixture("small_422_progressive.jpg"),
    "progressive_gray": lambda: synth_jpeg(40, 24, seed=33, mode="L",
                                           progressive=True),
    "quirk": lambda: quirk_jpeg(0),
}


@pytest.mark.parametrize("name", HOST_DECODED)
def test_transcoded_stores_bit_equal_to_oracle(name):
    data = HOST_DECODED[name]()
    staged = stage_host_bits(data)
    assert isinstance(staged, StagedBits)
    # The transcoder's one synthetic table pair for every component.
    assert all(st.scan.comp_to_upair == (0,) * len(st.kept)
               for st in staged.scans)
    _assert_stores_match_oracle(staged, data)


@pytest.mark.parametrize("name", ["progressive_420", "quirk"])
def test_transcoded_pixels_match_jax_and_exact(name):
    data = HOST_DECODED[name]()
    exact = _exact(data)
    port = _decode(data, precision="exact")
    np.testing.assert_array_equal(port.numpy(), exact)
    np.testing.assert_array_equal(
        port.numpy(), _jax(data, precision="exact", interchange="bits"))
    fast = _decode(data)
    assert _max_diff(fast, _jax(data, interchange="bits")) <= 3
    assert _max_diff(fast, exact) <= 3


def test_restart_underrun_raises_as_the_host_does():
    """restart_underrun_prescan.jpg is malformed (data where RST3 must
    be): the prescan defers it, and the host decode raises. The port
    raises that FormatError, as the JAX decoder does."""
    data = (FIXTURE_DIR.parent / "restart_underrun_prescan.jpg").read_bytes()
    with pytest.raises(FormatError) as host:
        Decoder(data).decode_array()
    with pytest.raises(FormatError) as jax_err:
        _jax(data, interchange="bits")
    with pytest.raises(PortFormatError) as port_err:
        _decode(data)
    assert str(port_err.value) == str(jax_err.value) == str(host.value)


def _gray_frame(w: int, h: int):
    d = Decoder(synth_jpeg(w, h, seed=34, mode="L"), backend="numpy")
    d._decode_entropy_only()
    return d.frame


def test_transcoded_extreme_stores_plain_k1_bit_equal():
    """Wrap16 DC differences of category 16 (a 16-bit code plus 16
    magnitude bits fill K1's 32-bit window) and AC values of size 15."""
    frame = _gray_frame(40, 24)
    bs = frame.components[0].block_size
    nb = bs.width * bs.height
    rng = np.random.default_rng(0)
    store = rng.integers(-32767, 32768, (nb, 64), np.int64).astype(np.int16)
    store[3::4] = 0
    store[0, 0] = -32768         # diff -32768: category 16
    store[1, 0] = 32767          # diff 65535 -> wrap16 -1
    store[2, 0] = -32768         # diff -65535 -> wrap16 +1
    store[3, 0] = 0              # diff 32768: category 16 again
    store[4, 1:] = np.where(np.arange(63) % 2, 32767, -32767)   # size 15
    scan, staged = transcode_scan(frame, [store.reshape(-1)])
    st = _wire_scan(staged, ((0, 0),))
    np.testing.assert_array_equal(_stores(st)[0].numpy().reshape(-1),
                                  store.reshape(-1))


@pytest.mark.parametrize("name", ["small_444.jpg", "small_dri.jpg"])
def test_three_table_pairs_on_the_anchor_wire(name):
    """The SOF1 recipe: Cr gets its own (DC, AC) tables, 6 table rows; the
    delta wire declines the scan, the anchor wire carries it."""
    plain = fixture(name)
    data = three_table_pairs(plain)
    staged = stage_host_bits(data, precision="exact")
    (st,) = staged.scans
    assert st.wire == "anchor" and st.scan.tab_maxcode.shape == (6, 16)
    assert st.scan.comp_to_upair == (0, 1, 2)
    _assert_stores_match_oracle(staged, data)
    port = _decode(data, precision="exact")
    np.testing.assert_array_equal(port.numpy(), _exact(plain))
    np.testing.assert_array_equal(
        port.numpy(), _jax(data, precision="exact", interchange="bits"))


def test_anchor_wire_equals_delta_wire():
    """A scan the delta wire takes, forced onto the anchor wire: the same
    stores."""
    for st in stage_host_bits(fixture("small_422.jpg")).scans:
        assert st.wire == "delta"
        anchor = _anchor_scan(st.scan, st.kept)
        for a, b in zip(_stores(anchor), _stores(st)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


PREFIX_INPUTS = SMALL_FIXTURES + ("small_422_progressive.jpg",)


@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_prefix_bit_equal_to_bits_path(precision):
    data = [fixture(n) for n in PREFIX_INPUTS]
    out = {}
    for interchange in ("bits", "prefix"):
        with DeviceStreamDecoder(device="cpu", host_threads=2,
                                 precision=precision,
                                 interchange=interchange) as dec:
            out[interchange] = dec.decode_stream(data)
    for name, a, b in zip(PREFIX_INPUTS, out["prefix"], out["bits"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("layout", ["planar", "planar-pallas"])
def test_prefix_layouts_bit_equal_to_bits_path(layout):
    data = [fixture(n) for n in ("small_dri.jpg", "small_gray.jpg")]
    out = {}
    for interchange in ("bits", "prefix"):
        with DeviceStreamDecoder(device="cpu", host_threads=2, layout=layout,
                                 interchange=interchange) as dec:
            out[interchange] = dec.decode_stream(data)
    for a, b in zip(out["prefix"], out["bits"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_prefix_matches_jax_prefix_path():
    data = synth_jpeg(96, 64, seed=35, subsampling=1)
    port = _decode(data, precision="exact", interchange="prefix")
    np.testing.assert_array_equal(
        port.numpy(), _jax(data, precision="exact", interchange="prefix"))


def test_planar_pallas_runs_the_fp32_idct_at_exact_precision():
    """The reference's `reconstruct_planar_pallas` runs its fp32 kernel at
    either precision (`pallas_kernels.py:326-328`); the port keeps that."""
    data = fixture("small_dri.jpg")
    fast = _decode(data, layout="planar-pallas")
    exact = _decode(data, layout="planar-pallas", precision="exact")
    torch.testing.assert_close(exact, fast, rtol=0, atol=0)
    planar_exact = _decode(data, layout="planar", precision="exact")
    assert not torch.equal(planar_exact, fast)

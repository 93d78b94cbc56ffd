"""The port's own copy of the host stage (`jpeg_decoder_tpu_torch/host/`)
against the JAX package it was copied from, on the CPU.

For every committed fixture of the port, for the 3.4 Mpix fixture scaled to
1/2, 1/4 and 1/8, for the quirk stream, the three-table-pair stream and two
SOF3 streams:
- the copy's `Decoder(backend="numpy")` gives the same `decode_array()` and
  `info()` as the reference's;
- the port's `stage_host_bits` gives, per scan, the wire the reference's
  own staging gives: its prescan captures (`BitstreamCapture`) on the delta
  wire (`pack_delta`) or, where that declines, the anchor fields; its
  `transcode_decoded` for progressive and quirk streams; its lossless
  staging for SOF3. Compared: the words, the per-chunk words, the entry
  bits and block bases, `s_max`, the block count and the Huffman table
  arrays;
- the malformed `restart_underrun_prescan.jpg` raises FormatError with the
  same message from both;
- the copied batch merge `merge_image_packs_delta` gives the reference's
  merged wire for pairs and triples of fixtures (collapsed packs: one
  union class), merges multi-class packs as it does and declines a mix of
  single- and multi-class packs as it does; the port's own merge of its
  anchor wire decodes every image as its own wire does.
Tolerance: equal, element for element (the copy is the same code).
"""

import numpy as np
import pytest

from jpeg_decoder_tpu.decoder import Decoder as RefDecoder
from jpeg_decoder_tpu.entropy.device_scan import PrescanFallback
from jpeg_decoder_tpu.entropy.pallas_decode import pack_delta as ref_pack_delta
from jpeg_decoder_tpu.entropy.transcode import \
    transcode_decoded as ref_transcode_decoded
from jpeg_decoder_tpu.errors import FormatError as RefFormatError
from jpeg_decoder_tpu.models.stream import (BitstreamCapture,
                                            _LosslessCapture,
                                            stage_host_lossless)
from jpeg_decoder_tpu_torch import StagedBits, stage_host_bits
from jpeg_decoder_tpu_torch.host.decoder import Decoder
from jpeg_decoder_tpu_torch.host.errors import FormatError
from jpeg_decoder_tpu_torch.host.staging import StagedLossless

from torch_inputs import FIXTURE_DIR, fixture, quirk_jpeg, three_table_pairs

FIXTURES = tuple(sorted(p.name for p in FIXTURE_DIR.glob("*.jpg")))
SCALES = ((1024, 840), (512, 420), (256, 210))    # large_420 / 2, 4, 8


def _sof3(predictor: int, ncomp: int, precision: int, seed: int) -> bytes:
    from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

    return sof3_jpeg(sof3_samples(37, 53, ncomp, precision, 0, seed=seed),
                     predictor, 0, precision)


CASES = {f"fixture-{n}": (lambda n=n: fixture(n), None) for n in FIXTURES}
CASES.update({f"large_420-{w}x{h}": (lambda: fixture("large_420.jpg"), (w, h))
              for w, h in SCALES})
CASES.update({
    "quirk_jpeg": (lambda: quirk_jpeg(3), None),
    "three_table_pairs": (lambda: three_table_pairs(fixture("tower_420.jpg")),
                          None),
    "sof3-16bit-predictor6": (lambda: _sof3(6, 1, 16, 4), None),
    "sof3-8bit-3comp-predictor1": (lambda: _sof3(1, 3, 8, 5), None),
})


def _decoders(case):
    make, scale_to = CASES[case]
    data = make()
    out = []
    for cls in (Decoder, RefDecoder):
        d = cls(data, backend="numpy")
        if scale_to is not None:
            d.scale(*scale_to)
        out.append(d)
    return data, scale_to, out


@pytest.mark.parametrize("case", list(CASES))
def test_copied_decoder_equals_the_reference(case):
    _data, _scale, (port, ref) = _decoders(case)
    got, want = port.decode_array(), ref.decode_array()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    a, b = port.info(), ref.info()
    assert (a.width, a.height, a.pixel_format.value, a.coding_process.value) \
        == (b.width, b.height, b.pixel_format.value, b.coding_process.value)


def _reference_scans(data: bytes, scale_to):
    """The reference's staged scans, as its `stage_host_bits` makes them:
    prescan captures, or on PrescanFallback / progressive frames the
    transcoded host decode. None for lossless frames."""
    d = RefDecoder(data, backend="numpy")
    cap, ll_cap = BitstreamCapture(), _LosslessCapture()
    d._prefix_capture, d._lossless_capture = cap, ll_cap
    try:
        if scale_to is not None:
            d.scale(*scale_to)
        d._decode_entropy_only()
    except PrescanFallback:
        d = RefDecoder(data, backend="numpy")
        if scale_to is not None:
            d.scale(*scale_to)
        d._decode_entropy_only()
        return ref_transcode_decoded(d, "fast").scans
    if ll_cap.scans:
        return None
    if not cap.used:
        return ref_transcode_decoded(d, "fast").scans
    return tuple(cap.scans)


def _reference_wire(scan) -> dict:
    """The wire fields the reference's staging gives one scan: pack_delta's
    delta wire, or the anchor fields where pack_delta declines."""
    packed = ref_pack_delta(scan)
    if packed is not None:
        (words, dm, _cnts), shapes = packed
        return {"words": words, "dm": dm,
                "s_max": max(s for (_sw, s, _nb, _ni) in shapes)}
    n = scan.n_items
    budget = scan.anchor_block[1:n + 1].astype(np.int64) - scan.anchor_block[:n]
    slot = scan.anchor_slot[:n].astype(np.int64)
    return {"words": np.ascontiguousarray(scan.words[:max(scan.n_words, 1)],
                                          np.uint32).view(np.int32),
            "dm": (budget << 4 | slot).astype(np.int32),
            "ab": np.ascontiguousarray(scan.anchor_bits[:n], np.uint32)
            .view(np.int32),
            "base": scan.anchor_block[:n].astype(np.int32),
            "s_max": max(int(scan.chunk_syms[:n].max()), 1)}


@pytest.mark.parametrize("case", list(CASES))
def test_staged_wire_equals_the_reference(case):
    make, scale_to = CASES[case]
    data = make()
    staged = stage_host_bits(data, scale_to)
    ref_scans = _reference_scans(data, scale_to)
    if ref_scans is None:   # lossless: the difference planes
        assert isinstance(staged, StagedLossless)
        want = stage_host_lossless(data, scale_to)
        np.testing.assert_array_equal(staged.diffs, want.diffs)
        assert (staged.predictor, staged.point_transform, staged.precision,
                staged.restart_all, staged.out_width, staged.out_height) == \
            (want.predictor, want.point_transform, want.precision,
             want.restart_all, want.out_width, want.out_height)
        return
    assert isinstance(staged, StagedBits)
    assert len(staged.scans) == len(ref_scans)
    for st, (ref, kept) in zip(staged.scans, ref_scans):
        assert st.kept == tuple(kept)
        want = _reference_wire(ref)
        assert st.wire == ("anchor" if "ab" in want else "delta")
        for name in ("words", "dm", "ab", "base"):
            if name in want:
                np.testing.assert_array_equal(getattr(st, name), want[name])
        assert st.s_max == want["s_max"]
        assert st.scan.plan.n_blocks == ref.plan.n_blocks
        assert st.scan.plan.pattern == ref.plan.pattern
        for name in ("tab_maxcode", "tab_delta", "tab_values"):
            np.testing.assert_array_equal(getattr(st.scan, name),
                                          getattr(ref, name))
        assert tuple(st.scan.comp_to_upair) == tuple(ref.comp_to_upair)


@pytest.mark.parametrize("name", ["large_420_progressive.jpg",
                                  "small_422_progressive.jpg"])
def test_transcode_gives_the_reference_wire(name):
    from jpeg_decoder_tpu_torch.host.entropy.transcode import \
        transcode_decoded

    data = fixture(name)
    port, ref = Decoder(data, backend="numpy"), RefDecoder(data,
                                                           backend="numpy")
    port._decode_entropy_only()
    ref._decode_entropy_only()
    got, want = transcode_decoded(port, "fast"), ref_transcode_decoded(
        ref, "fast")
    assert len(got.scans) == len(want.scans) == 1
    (a, kept_a), (b, kept_b) = got.scans[0], want.scans[0]
    assert kept_a == kept_b and a.n_items == b.n_items
    for field in ("words", "anchor_bits", "anchor_block", "anchor_slot",
                  "chunk_end", "chunk_syms", "tab_maxcode", "tab_delta",
                  "tab_values"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_restart_underrun_raises_the_same_format_error():
    data = (FIXTURE_DIR.parent / "restart_underrun_prescan.jpg").read_bytes()
    with pytest.raises(RefFormatError) as ref:
        RefDecoder(data, backend="numpy").decode_array()
    with pytest.raises(FormatError) as port:
        Decoder(data, backend="numpy").decode_array()
    with pytest.raises(FormatError) as staged:
        stage_host_bits(data)
    assert str(port.value) == str(staged.value) == str(ref.value)


# The batch merge of the delta wire (`merge_image_packs_delta`, copied) and
# the port's own anchor-wire merge.
MERGE_GROUPS = {
    "pair-444-422": ("small_444.jpg", "small_422.jpg"),
    "pair-tower-dri": ("tower_420.jpg", "small_dri.jpg"),
    "triple-gray-cmyk-rgb": ("small_gray.jpg", "small_cmyk_420.jpg",
                             "small_rgb_444.jpg"),
    "triple-large-444-progressive": ("large_420.jpg", "small_444.jpg",
                                     "small_422_progressive.jpg"),
}


def _delta_entries(names):
    """(port entries, reference entries, block counts) of the fixtures'
    delta-wire packs, staged by each package."""
    port, ref, nbs = [], [], []
    for name in names:
        data = fixture(name)
        (st,) = stage_host_bits(data).scans
        (scan, _kept), = _reference_scans(data, None)
        assert st.wire == "delta"
        port.append(((st.words, st.dm, st.cnts), st.shapes))
        ref.append(ref_pack_delta(scan))
        nbs.append(st.scan.plan.n_blocks)
    return port, ref, nbs


def _assert_merges_equal(got, want):
    if want is None:
        assert got is None
        return
    (gw, gd, gc), gs = got
    (ww, wd, wc), ws = want
    for a, b in ((gw, ww), (gd, wd), (gc, wc)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert gs == ws


@pytest.mark.parametrize("group", list(MERGE_GROUPS))
def test_delta_merge_equals_the_reference(group):
    """Collapsed (single-class) packs, the default: their classes union."""
    from jpeg_decoder_tpu.entropy.pallas_decode import \
        merge_image_packs_delta as ref_merge
    from jpeg_decoder_tpu_torch.host.entropy.wire import \
        merge_image_packs_delta

    port, ref, nbs = _delta_entries(MERGE_GROUPS[group])
    want = ref_merge(ref, nbs)
    assert want is not None and len(want[1]) == 1     # one union class
    _assert_merges_equal(merge_image_packs_delta(port, nbs), want)


def _split_classes(entry):
    """The pack's chunks as two classes (its first half one class wider),
    as span classes would give them."""
    (words, dm, cnts), ((sw, sm, nb, n),) = entry
    a = n // 2
    return ((words, dm, np.asarray([a, n - a], np.int32)),
            ((sw, sm, nb, a), (sw + 8, sm, nb, n - a)))


@pytest.mark.parametrize("multi", ["first", "all"])
def test_delta_merge_of_multi_class_packs_equals_the_reference(multi):
    """A mix of single- and multi-class packs: both decline. Multi-class
    packs alone: both merge per class."""
    from jpeg_decoder_tpu.entropy.pallas_decode import \
        merge_image_packs_delta as ref_merge
    from jpeg_decoder_tpu_torch.host.entropy.wire import \
        merge_image_packs_delta

    port, ref, nbs = _delta_entries(("small_444.jpg", "small_dri.jpg"))
    for entries in (port, ref):
        for i in range(len(entries) if multi == "all" else 1):
            entries[i] = _split_classes(entries[i])
    want = ref_merge(ref, nbs)
    assert (want is None) == (multi == "first")
    _assert_merges_equal(merge_image_packs_delta(port, nbs), want)


def test_merged_anchor_wire_decodes_bit_equal_to_each_image():
    """Two three-table-pair streams (the anchor wire) merged: one K1 sweep
    gives each image's rows of its own sweep, and a batched stream each
    image's own decode."""
    import torch

    from jpeg_decoder_tpu_torch import DeviceStreamDecoder
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import decode_chunks
    from jpeg_decoder_tpu_torch.models.stream import merge_scans
    from jpeg_decoder_tpu_torch.params import DeviceParams

    blobs = [three_table_pairs(fixture(n))
             for n in ("small_dri.jpg", "small_444.jpg")]
    scans = [stage_host_bits(b).scans[0] for b in blobs]
    assert [s.wire for s in scans] == ["anchor", "anchor"]
    params = DeviceParams("cpu")

    def sweep(arrays, s_max, n_blocks):
        return decode_chunks(*map(torch.from_numpy, arrays),
                             params.tables(scans[0].scan), s_max, n_blocks)

    arrays, s_max, n_blocks = merge_scans(scans)
    merged = sweep(arrays, s_max, n_blocks)
    off = 0
    for s in scans:
        nb = s.scan.plan.n_blocks
        alone = sweep((s.words, s.dm, s.ab, s.base), s.s_max, nb)
        assert torch.equal(merged[off:off + nb], alone)
        off += nb
    assert off == n_blocks
    stream = [blobs[0], blobs[0], blobs[0]]
    with DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
        single = dec.decode_stream(stream[:1])[0]
        for img in dec.decode_stream(stream, batch_size=3):
            assert torch.equal(img, single)

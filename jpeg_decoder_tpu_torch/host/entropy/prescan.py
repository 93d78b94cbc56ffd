"""Copy of the host half of `jpeg_decoder_tpu/entropy/device_scan.py`
(`:1-778`) at commit 0c2d0ea: `ScanPlan`, `AnchoredScan`,
`PrescanFallback`, `prescan_baseline` and its LUT and geometry helpers.
The device decoders of that module (`build_anchored_decoder` and the
assembler, jnp code) are not copied; the port's kernel K1 and
`entropy/assemble.py` take their place.

The JAX package's description of the engine follows.

Device-side baseline entropy decode: anchored parallel Huffman on TPU.

The round-1 interchange shipped decoded coefficients (~0.9 B/px) to the chip;
the link, not the chip, set the sustained ceiling. This engine ships the
*entropy-coded bytes themselves* (~0.15-0.3 B/px) plus a sparse set of
bitstream anchors, and runs Huffman decode on the device:

- Host: unstuff the scan (0xFF00 removal, RST segment split — byte-parallel),
  then a cheap *prescan* that walks symbol lengths only (no coefficient
  emission, no stores) and records an anchor (bit offset, stream block index)
  every ~S symbols at a block boundary. Restart boundaries force anchors, so
  DRI segments and intra-image chunks use one mechanism (SURVEY.md §2a's
  entropy-segment parallelism, generalized to DRI-less streams).
- Device: thousands of chunks decode in parallel from exact entry states —
  bit-exact by construction, no speculation to verify. A `lax.scan` over
  symbol steps drives a 16-bit-window Huffman LUT (one gather per symbol),
  emitting (position, value) pairs; assembly is one scatter + static gathers
  + segmented prefix sums for the DC predictor chains
  (`src/decoder.rs:1102-1118` semantics — wrapping i16).

Scans whose streams exercise decoder quirks that only malformed/progressive
content hits (EOB runs in a sequential scan, DC category > 11, run overshoot,
invalid codes) are detected by the prescan and fall back to the host engines,
which reproduce the reference bit-for-bit. Valid baseline content — the
entirety of the production path — decodes on device.

Semantics mirrored from `src/decoder.rs:863-1172` and
`src/huffman.rs:14-160` via this repo's oracle (entropy/scan_python.py).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np

from ..errors import FormatError, IoError, JpegError
from ..parser import CodingProcess
from .. import markers as M
from .scan_python import UNZIGZAG, _finish_scan

# Chunking policy: anchor every ~S_TARGET symbols (or K_CAP blocks) at a block
# boundary. S_MAX bounds the device scan length: one block may overshoot the
# symbol budget by up to 64 coefficients + EOB. K_CAP is small so the Pallas
# kernel's dense per-chunk output region (K_CAP*64 coefficients) stays cheap
# to accumulate one-hot and nearly padding-free.
S_TARGET = 96
# Chunk block budget: warmed-link A/B over {8,16,24} x S_TARGET {64,96,144}
# (tools/experiments/kcap_ab.py) puts device decode within 6.3-7.2 ms/img for
# all of them, while H2D falls monotonically with K_CAP (0.392 -> 0.320 ->
# 0.284 B/px). The link is the sustained bottleneck, so take the smallest
# wire format; 31 exceeds the 16MB VMEM scoped limit for the dense region.
K_CAP = 24
S_MAX = S_TARGET + 66

_LUT_CACHE: dict = {}


def build_decode_lut16(table) -> np.ndarray:
    """16-bit-window decode LUT for one Huffman table: entry = value | len<<8.

    Reproduces the oracle's decode exactly (8-bit LUT + F.16 canonical walk,
    `entropy/bitreader.py:101-120`): for every 16-bit window the shortest
    matching code wins. Windows matching no code get len=0 (only reachable on
    malformed streams, which the prescan routes to the host path).
    """
    key = (table.values.tobytes(), table.maxcode.tobytes(), table.delta.tobytes())
    cached = _LUT_CACHE.get(key)
    if cached is not None:
        return cached

    lut = np.zeros(1 << 16, np.uint32)
    # Reconstruct canonical (code, length) spans from maxcode/delta
    # (Annex C: mincode_L = huffcode[j_start] = j_start - delta[L-1]).
    j = 0
    for L in range(1, 17):
        if table.maxcode[L - 1] < 0:
            continue
        mincode = j - int(table.delta[L - 1])
        maxcode = int(table.maxcode[L - 1])
        count = maxcode - mincode + 1
        vals = table.values[j:j + count].astype(np.uint32)
        j += count
        shift = 16 - L
        starts = (np.arange(mincode, maxcode + 1, dtype=np.uint32) << shift)
        span = 1 << shift
        entry = vals | np.uint32(L << 8)
        # Each code c owns windows [c<<shift, (c+1)<<shift). Canonical codes
        # are prefix-free, so spans never overlap across lengths.
        lut.reshape(-1, span)[starts >> shift] = entry[:, None]
    if len(_LUT_CACHE) > 64:
        _LUT_CACHE.clear()
    _LUT_CACHE[key] = lut
    return lut


class PrescanFallback(Exception):
    """Stream exercises semantics the device engine defers to the host for."""


@dataclasses.dataclass
class AnchoredScan:
    """One baseline scan staged for device decode."""
    words: np.ndarray         # uint32 [n_words] big-endian packed unstuffed bits
    anchor_bits: np.ndarray   # uint32 [n_items] chunk entry bit offsets
    anchor_block: np.ndarray  # int32 [n_items + 1] stream block index (sentinel-terminated)
    anchor_slot: np.ndarray   # int32 [n_items] MCU-pattern slot at chunk entry
    luts: np.ndarray          # uint32 [2 * n_pairs, 65536]
    n_blocks: int
    plan: "ScanPlan"
    chunk_end: np.ndarray = None    # uint32 [n_items] bit offset after last symbol
    chunk_syms: np.ndarray = None   # int32 [n_items] symbols in chunk
    n_items: int = 0
    n_words: int = 0          # true packed words (words[] is bucket-padded)
    # Canonical-table metadata for the Pallas kernel: rows ordered
    # (pair0_dc, pair0_ac, pair1_dc, ...) like `luts`.
    tab_maxcode: np.ndarray = None  # int32 [n_tab, 16] (unique pairs only)
    tab_delta: np.ndarray = None    # int32 [n_tab, 16]
    tab_values: np.ndarray = None   # uint32 [n_tab, 64] (256 bytes LE-packed)
    comp_to_upair: tuple = None     # scan component pos -> unique pair index
    # Parsed syntax objects, kept for derived staging (stripe splitting
    # builds per-stripe sub-plans from them; parallel/stripe_bits.py).
    frame: object = None
    scan: object = None


def unstuff_scan(data, pos: int):
    """Split the entropy-coded span at `pos` into unstuffed RST segments.

    Mirrors the oracle bit reader's byte layer (`entropy/bitreader.py:40-90`):
    0xFF00 emits 0xFF; fill 0xFFs before a marker are skipped; RSTn ends a
    segment; any other marker ends the scan. Returns
    (segments: list[bytes], rst_nums: list[int], end_pos, pending_marker).
    Raises IoError/FormatError exactly where the oracle would (EOF while
    scanning, FF00 after fill bytes).
    """
    n = len(data)
    segments = []
    rst_nums = []
    seg = bytearray()
    i = pos
    while True:
        if i >= n:
            # The oracle raises IoError only when the *reader* consumes past
            # EOF; a scan whose symbols completed earlier never reads here.
            # We conservatively treat EOF-without-marker as "segment ends at
            # EOF, no pending marker"; the prescan raises IoError if the
            # symbol walk actually needs bytes past this point.
            segments.append(bytes(seg))
            return segments, rst_nums, i, None, True
        b = data[i]
        if b != 0xFF:
            seg.append(b)
            i += 1
            continue
        if i + 1 >= n:
            segments.append(bytes(seg))
            return segments, rst_nums, i + 1, None, True
        nxt = data[i + 1]
        if nxt == 0x00:
            seg.append(0xFF)
            i += 2
            continue
        j = i + 1
        while data[j] == 0xFF:
            j += 1
            if j >= n:
                segments.append(bytes(seg))
                return segments, rst_nums, j, None, True
        nxt = data[j]
        if nxt == 0x00:
            raise FormatError("FF 00 found where marker was expected")
        marker = nxt
        i = j + 1
        if M.is_rst(marker):
            segments.append(bytes(seg))
            rst_nums.append(M.rst_index(marker))
            seg = bytearray()
            continue
        segments.append(bytes(seg))
        return segments, rst_nums, i, marker, False


def _stream_blocks(frame, scan):
    """Enumerate scan blocks in bitstream order, mirroring the MCU loop incl.
    the `mcu*8 >= image` clip quirk (`src/decoder.rs:910-917`
    / scan_python.py:277-303). Yields (comp_pos, block_y, block_x, mcu_index,
    slot) where slot cycles through the per-MCU block pattern."""
    components = [frame.components[i] for i in scan.component_indices]
    interleaved = len(components) > 1
    if interleaved:
        hs = [c.horizontal_sampling_factor for c in components]
        vs = [c.vertical_sampling_factor for c in components]
        max_x, max_y = frame.mcu_size.width, frame.mcu_size.height
    else:
        hs = [1]
        vs = [1]
        max_x = components[0].block_size.width
        max_y = components[0].block_size.height
    w, h = frame.image_size.width, frame.image_size.height
    mcu = 0
    for my in range(max_y):
        if my * 8 >= h:
            break
        for mx in range(max_x):
            if mx * 8 >= w:
                break
            slot = 0
            for i in range(len(components)):
                for v in range(vs[i]):
                    for hh in range(hs[i]):
                        yield i, my * vs[i] + v, mx * hs[i] + hh, mcu, slot
                        slot += 1
            mcu += 1


class ScanPlan:
    """Static (trace-time) layout for one (frame geometry, scan) shape:
    stream-order block maps, per-MCU table-pair pattern, DC segmentation.
    Hashable by geometry key so jitted decoders are shared across images."""

    def __init__(self, frame, scan, restart_interval: int,
                 items_bucket: int, words_bucket: int, s_max: int = S_MAX):
        self.s_max = s_max
        components = [frame.components[i] for i in scan.component_indices]
        self.ncomp = len(components)
        self.restart_interval = restart_interval
        self.items_bucket = items_bucket
        self.words_bucket = words_bucket

        blocks = list(_stream_blocks(frame, scan))
        self.n_blocks = len(blocks)
        self.pattern = []
        if blocks:
            first_mcu_len = sum(1 for b in blocks if b[3] == 0)
            self.pattern = [blocks[s][0] for s in range(first_mcu_len)]
        self.block_widths = [c.block_size.width for c in components]
        self.store_shapes = [
            (c.block_size.height * c.block_size.width) for c in components]

        # Per component: stream-appearance order -> raster block index, and
        # the inverse gather (raster -> stream position, sentinel = zeros row).
        self.stream_idx = []      # [ncomp] arrays: global stream index of comp blocks
        self.raster_src = []      # [ncomp] arrays: raster -> row in comp stream list
        self.seg_first = []       # [ncomp] arrays: per comp-block, index of first
                                  # comp-block in its restart segment
        for i, comp in enumerate(components):
            s_idx = np.array([k for k, b in enumerate(blocks) if b[0] == i],
                             np.int32)
            self.stream_idx.append(s_idx)
            raster = np.array(
                [b[1] * self.block_widths[i] + b[2]
                 for b in blocks if b[0] == i], np.int64)
            src = np.full(self.store_shapes[i], len(s_idx), np.int64)
            src[raster] = np.arange(len(s_idx))
            self.raster_src.append(src)
            if restart_interval > 0:
                seg = np.array([b[3] // restart_interval
                                for b in blocks if b[0] == i], np.int64)
            else:
                seg = np.zeros(len(s_idx), np.int64)
            first = np.zeros(len(s_idx), np.int64)
            if len(seg):
                starts = np.flatnonzero(np.diff(seg, prepend=-1))
                first = starts[np.searchsorted(starts, np.arange(len(seg)),
                                               side="right") - 1]
            self.seg_first.append(first)

        self.structured = self._derive_structured(frame, scan, components)

        self._key = (
            frame.image_size.width, frame.image_size.height,
            tuple(scan.component_indices),
            tuple((c.horizontal_sampling_factor, c.vertical_sampling_factor,
                   c.block_size.width, c.block_size.height)
                  for c in components),
            restart_interval, items_bucket, words_bucket, s_max,
        )

    def _derive_structured(self, frame, scan, components):
        """Express the stream<->raster maps as reshape/slice/transpose/pad
        parameters instead of general index arrays. XLA lowers the general
        row gathers in the assembler far below copy speed; the structured
        form is static data movement. The derivation is *verified* element
        for element against the general arrays built from _stream_blocks —
        any mismatch (quirk geometry this closed form doesn't model) returns
        None and the assembler keeps the gather path, so this is purely an
        execution-strategy choice, never a semantics change.

        Returns ((n_mcus, rows_d, cols_d, plen),
                 per-comp (slot0, bpm, vs, hs, Hc, W, seg_blocks)) or None.
        """
        plen = len(self.pattern)
        if plen == 0 or self.n_blocks % plen:
            return None
        n_mcus = self.n_blocks // plen
        interleaved = len(components) > 1
        if interleaved:
            max_x, max_y = frame.mcu_size.width, frame.mcu_size.height
        else:
            max_x = components[0].block_size.width
            max_y = components[0].block_size.height
        w, h = frame.image_size.width, frame.image_size.height
        # Decoded MCU grid incl. the mcu*8 >= image clip quirk
        # (`src/decoder.rs:910-917`).
        rows_d = sum(1 for my in range(max_y) if my * 8 < h)
        cols_d = sum(1 for mx in range(max_x) if mx * 8 < w)
        if rows_d * cols_d != n_mcus:
            return None

        specs = []
        slot0 = 0
        for i, comp in enumerate(components):
            if interleaved:
                hs = comp.horizontal_sampling_factor
                vs = comp.vertical_sampling_factor
            else:
                hs = vs = 1
            bpm = hs * vs
            W = self.block_widths[i]
            if W <= 0:
                return None
            Hc = self.store_shapes[i] // W
            n_c = len(self.stream_idx[i])
            if (n_c != n_mcus * bpm or Hc * W != self.store_shapes[i]
                    or rows_d * vs > Hc or cols_d * hs > W):
                return None
            cand = (np.arange(n_mcus, dtype=np.int64)[:, None] * plen
                    + slot0 + np.arange(bpm)[None, :]).reshape(-1)
            if not np.array_equal(cand, self.stream_idx[i]):
                return None
            pos = np.arange(n_c, dtype=np.int64).reshape(
                rows_d, cols_d, vs, hs).transpose(0, 2, 1, 3)
            grid = np.full((Hc, W), n_c, np.int64)
            grid[:rows_d * vs, :cols_d * hs] = pos.reshape(
                rows_d * vs, cols_d * hs)
            if not np.array_equal(grid.reshape(-1), self.raster_src[i]):
                return None
            if self.restart_interval > 0:
                seg_blocks = self.restart_interval * bpm
                cand_first = (np.arange(n_c, dtype=np.int64)
                              // seg_blocks) * seg_blocks
            else:
                seg_blocks = 0
                cand_first = np.zeros(n_c, np.int64)
            if not np.array_equal(cand_first, self.seg_first[i]):
                return None
            specs.append((slot0, bpm, vs, hs, Hc, W, seg_blocks))
            slot0 += bpm
        return ((n_mcus, rows_d, cols_d, plen), tuple(specs))

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, ScanPlan) and self._key == other._key


def _bucket_up(n: int, floor: int = 256, factor: float = 1.3) -> int:
    """Compile-friendly size bucket: geometric steps, 256-aligned. Every
    distinct padded length is a distinct XLA executable (and first compiles
    through the relay cost seconds-minutes), so stream-length granularity
    must be coarse; `factor` trades mean zero-padding for executable count."""
    size = floor
    while size < n:
        size = int(size * factor) + (-int(size * factor) % 256)
    return size


def _prescan_geometry(frame, scan, restart_interval: int) -> dict:
    """Scalar geometry for the C++ prescan, mirroring _stream_blocks incl.
    the mcu*8 clip quirk."""
    components = [frame.components[i] for i in scan.component_indices]
    interleaved = len(components) > 1
    if interleaved:
        max_x, max_y = frame.mcu_size.width, frame.mcu_size.height
        pattern = []
        for i, c in enumerate(components):
            pattern.extend([i] * (c.horizontal_sampling_factor
                                  * c.vertical_sampling_factor))
    else:
        max_x = components[0].block_size.width
        max_y = components[0].block_size.height
        pattern = [0]
    w, h = frame.image_size.width, frame.image_size.height
    rows = min(max_y, (h + 7) // 8)
    cols = min(max_x, (w + 7) // 8)
    n_mcus = rows * cols
    nseg = ((n_mcus + restart_interval - 1) // restart_interval
            if restart_interval else 1)
    return {
        "ncomp": len(components), "max_mcu_x": max_x, "max_mcu_y": max_y,
        "image_w": w, "image_h": h, "restart_interval": restart_interval,
        "pattern": pattern, "est_segments": nseg,
        "est_blocks": n_mcus * len(pattern),
        # All scan components sharing (dc, ac) table indices lets the
        # speculative prescan key candidate states on bit position alone
        # (slot phase cannot change the decode) — see entropy.cc
        # spec_walk_span. Distinct indices with identical contents are
        # conservatively treated as non-uniform.
        "uniform_tables": int(
            len(set(scan.dc_table_indices)) == 1
            and len(set(scan.ac_table_indices)) == 1),
    }


def _s_max_bucket(n: int) -> int:
    """Per-scan device step budget, bucketed for compile-cache hits. The
    prescan guarantees n <= S_MAX; the transcoder's larger chunks (symbol
    target 160 + one block overshoot) reach 223 — the 224 top bucket matches
    pallas_decode.SYM_BUCKETS' ceiling."""
    for b in (16, 32, 64, 96, 128, S_MAX, 224):
        if n <= b:
            return b
    raise ValueError(f"chunk symbol count {n} exceeds the device budget")


def _staged_from_layout(frame, scan, restart_interval, luts, out_bytes,
                        a_bits, a_block, a_slot, n_blocks,
                        a_end=None, a_syms=None) -> "AnchoredScan":
    """Common tail: pack the padded byte layout into u32 words, bucket the
    shapes, and attach the (cached) static plan."""
    out_bytes = np.asarray(out_bytes, np.uint8)
    pad = (-len(out_bytes)) % 4 + 8
    n_words = (len(out_bytes) + pad) // 4

    n_items = len(a_bits)
    items_bucket = _bucket_up(n_items)
    words_bucket = _bucket_up(n_words, 1024)
    # Big-endian word packing in two passes: write the stream into the padded
    # buffer's byte view, then byteswap the populated words in place (zeros
    # beyond stay zero). Replaces a concatenate + reshape + 4x u32 widen +
    # 3 shift-or passes over the whole stream.
    wpad = np.zeros(words_bucket, np.uint32)
    wpad.view(np.uint8)[:len(out_bytes)] = out_bytes
    if sys.byteorder == "little":
        wpad[:n_words].byteswap(inplace=True)

    anchor_bits = np.zeros(items_bucket, np.uint32)
    anchor_bits[:n_items] = a_bits
    anchor_block = np.full(items_bucket + 1, n_blocks, np.int32)
    anchor_block[:n_items] = a_block
    anchor_slot = np.zeros(items_bucket, np.int32)
    anchor_slot[:n_items] = a_slot

    s_max = S_MAX
    chunk_end = chunk_syms = None
    if a_syms is not None and len(a_syms) == n_items:
        s_max = _s_max_bucket(int(a_syms.max()) if n_items else 1)
        chunk_end = np.zeros(items_bucket, np.uint32)
        chunk_end[:n_items] = a_end
        chunk_syms = np.zeros(items_bucket, np.int32)
        chunk_syms[:n_items] = a_syms

    plan = _plan_for(frame, scan, restart_interval, items_bucket, words_bucket,
                     s_max)
    return AnchoredScan(words=wpad, anchor_bits=anchor_bits,
                        anchor_block=anchor_block, anchor_slot=anchor_slot,
                        luts=luts, n_blocks=n_blocks, plan=plan,
                        chunk_end=chunk_end, chunk_syms=chunk_syms,
                        n_items=n_items, n_words=n_words,
                        frame=frame, scan=scan)


_PLAN_CACHE: dict = {}


def _plan_key(frame, scan, restart_interval, items_bucket, words_bucket,
              s_max):
    components = [frame.components[i] for i in scan.component_indices]
    return (
        frame.image_size.width, frame.image_size.height,
        tuple(scan.component_indices),
        tuple((c.horizontal_sampling_factor, c.vertical_sampling_factor,
               c.block_size.width, c.block_size.height) for c in components),
        restart_interval, items_bucket, words_bucket, s_max,
    )


def _plan_for(frame, scan, restart_interval, items_bucket, words_bucket,
              s_max=S_MAX):
    key = _plan_key(frame, scan, restart_interval, items_bucket, words_bucket,
                    s_max)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = ScanPlan(frame, scan, restart_interval, items_bucket,
                        words_bucket, s_max)
        if len(_PLAN_CACHE) > 128:
            _PLAN_CACHE.clear()
        _PLAN_CACHE[key] = plan
    return plan


_SCAN_LUTS_CACHE: dict = {}


def scan_decode_luts(scan, dc_tables, ac_tables):
    """Fused 16-bit decode LUTs in the C prescan's wire layout — per scan
    component, a (dc, ac) pair of [65536] rows, concatenated to
    [2*ncomp, 65536]. The ONLY place this layout is defined; both the
    device-prescan path and the host anchored-staging path feed it to
    jt_prescan_baseline. Returns None when any referenced table is unset.

    The concatenated array is cached by table content: images from one
    encoder share tables, and restacking ~0.5 MB of (already-cached) LUT
    rows per image was a measurable slice of serial staging."""
    tabs = []
    for i in range(len(scan.component_indices)):
        dct = dc_tables[scan.dc_table_indices[i]]
        act = ac_tables[scan.ac_table_indices[i]]
        if dct is None or act is None:
            return None
        tabs.append((dct, act))
    key = tuple(t.values.tobytes() + t.maxcode.tobytes() + t.delta.tobytes()
                for pair in tabs for t in pair)
    cached = _SCAN_LUTS_CACHE.get(key)
    if cached is not None:
        return cached
    out = np.concatenate([np.stack([build_decode_lut16(dct),
                                    build_decode_lut16(act)])
                          for dct, act in tabs])
    if len(_SCAN_LUTS_CACHE) > 64:
        _SCAN_LUTS_CACHE.clear()
    _SCAN_LUTS_CACHE[key] = out
    return out


def prescan_baseline(cursor, frame, scan, dc_tables, ac_tables,
                     restart_interval: int) -> "tuple[Optional[int], AnchoredScan]":
    """Host prescan: symbol-length walk producing device anchors.

    Mirrors `decode_scan_dct` (scan_python.py:228-314) without emitting
    coefficients. Raises PrescanFallback for streams whose decode exercises
    host-only semantics; raises the oracle's own typed errors for malformed
    streams the oracle would reject at the same point.
    """
    if frame.coding_process == CodingProcess.DCT_PROGRESSIVE:
        raise PrescanFallback("progressive")
    if scan.spectral_selection_start != 0 or scan.spectral_selection_end != 64 \
            or scan.successive_approximation_low != 0:
        raise PrescanFallback("non-baseline spectral parameters")

    components = [frame.components[i] for i in scan.component_indices]
    npairs = len(components)
    luts = scan_decode_luts(scan, dc_tables, ac_tables)
    if luts is None:
        raise PrescanFallback("missing table")
    dc_luts = [luts[2 * i] for i in range(npairs)]
    ac_luts = [luts[2 * i + 1] for i in range(npairs)]

    def _pack_values(tab) -> np.ndarray:
        v = np.zeros(256, np.uint8)
        v[:len(tab.values)] = tab.values
        w = v.reshape(64, 4).astype(np.uint32)
        return w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16) | (w[:, 3] << 24)

    # Unique (dc, ac) pairs: chroma components typically share one pair, so
    # color scans need only 2 unique pairs (the Pallas kernel's limit is 2).
    unique_pairs = []
    comp_to_upair = []
    for i in range(npairs):
        key = (scan.dc_table_indices[i], scan.ac_table_indices[i])
        if key not in unique_pairs:
            unique_pairs.append(key)
        comp_to_upair.append(unique_pairs.index(key))
    tabs = []
    for (dci, aci) in unique_pairs:
        tabs.append(dc_tables[dci])
        tabs.append(ac_tables[aci])
    tab_maxcode = np.stack([t.maxcode.astype(np.int32) for t in tabs])
    tab_delta = np.stack([t.delta.astype(np.int32) for t in tabs])
    tab_values = np.stack([_pack_values(t) for t in tabs])
    comp_to_upair = tuple(comp_to_upair)

    def _attach_meta(st):
        st.tab_maxcode = tab_maxcode
        st.tab_delta = tab_delta
        st.tab_values = tab_values
        st.comp_to_upair = comp_to_upair
        return st

    from .native import get_native
    native = get_native()
    if native is not None and hasattr(native, "prescan_baseline"):
        geometry = _prescan_geometry(frame, scan, restart_interval)
        res = native.prescan_baseline(cursor, luts, geometry,
                                      S_TARGET, K_CAP, S_MAX)
        if res is None:
            # The C++ and Python walks share bounds and fallback policy;
            # don't re-walk in Python, go straight to the host engines.
            raise PrescanFallback("native prescan fallback")
        out_bytes, a_bits, a_block, a_slot, n_blocks, pending, a_end, a_syms = res
        staged = _staged_from_layout(
            frame, scan, restart_interval, luts,
            np.asarray(out_bytes), a_bits, a_block, a_slot, n_blocks,
            a_end, a_syms)
        return pending, _attach_meta(staged)

    try:
        segments, rst_nums, end_pos, pending, hit_eof = unstuff_scan(
            cursor.data, cursor.pos)
    except JpegError as e:
        raise PrescanFallback(f"unstuff: {e}")
    if hit_eof:
        # The oracle always errors on scans not terminated by a marker
        # (take_marker's refill hits EOF); reproduce via the host path.
        raise PrescanFallback("EOF inside scan")
    if sum(len(s) + 24 for s in segments) >= (1 << 29):  # incl. per-seg pad
        # Anchor bit offsets ride the wire as uint32 (AnchoredScan /
        # jt_prescan_baseline, same guard): a >=2^29-byte layout would wrap
        # them silently.
        raise PrescanFallback("scan too large for uint32 anchor offsets")

    def seg_words(seg: bytes) -> "tuple[np.ndarray, int]":
        pad = seg + b"\x00" * ((-len(seg)) % 4 + 24)
        w = np.frombuffer(pad, np.uint8).reshape(-1, 4).astype(np.uint32)
        return (w[:, 0] << 24) | (w[:, 1] << 16) | (w[:, 2] << 8) | w[:, 3], \
            len(seg) * 8

    blocks = _stream_blocks(frame, scan)
    mcus_left = restart_interval
    expected_rst = 0
    seg_i = 0
    cur_words, seg_nbits = seg_words(segments[0])
    cur_words_l = cur_words.tolist()
    p = 0

    anchors = []          # (local_bit_in_segment, seg_index, stream_block, slot)
    chunk_ends = []       # (local_bit, seg_index) at chunk close
    chunk_syms = []
    syms_since = 0
    blocks_since = 0
    max_chunk_syms = 0
    MASK32 = 0xFFFFFFFF

    def decode_sym(pos: int, lut) -> "tuple[int, int]":
        # Overrun bound shared with the C++ prescan: at most 128 bits into a
        # segment's zero-fill; degenerate streams go through the host path.
        if pos > seg_nbits + 128:
            raise PrescanFallback("prescan overran segment padding")
        wi = pos >> 5
        b = pos & 31
        if b:
            win = ((cur_words_l[wi] << b) & MASK32) | (cur_words_l[wi + 1] >> (32 - b))
        else:
            win = cur_words_l[wi]
        ent = int(lut[win >> 16])
        length = (ent >> 8) & 0x1F
        if length == 0:
            raise PrescanFallback("unresolvable code")
        return ent & 0xFF, length

    stream_block = 0
    last_mcu = -1
    for (ci, by, bx, mcu, slot) in blocks:
        if mcu != last_mcu:
            last_mcu = mcu
            if restart_interval > 0:
                if mcus_left == 0:
                    # Oracle: take_marker must find RST(expected); mismatches
                    # go through the host path for exact error parity.
                    if seg_i >= len(rst_nums) or rst_nums[seg_i] != expected_rst:
                        raise PrescanFallback("restart protocol violation")
                    # Underrun before the marker (mirrors the C++ walk):
                    # take_marker is one read_bits refill (reads bytes while
                    # num_bits <= 56) + marker.take()
                    # (src/huffman.rs:123-160). It absorbs up
                    # to 56 unconsumed data bits before the RSTn (pad/fill
                    # bytes, MJPEG-style) and then reset() discards them;
                    # past 56 bits the reservoir fills before the 0xFF and
                    # the oracle errors "no marker found..."
                    # (src/decoder.rs:944-951) — host path
                    # owns that error semantics.
                    if seg_nbits - p > 56:
                        raise PrescanFallback(
                            "unconsumed bytes before restart")
                    if anchors and len(chunk_ends) < len(anchors):
                        chunk_ends.append((p, seg_i))
                        chunk_syms.append(syms_since)
                    seg_i += 1
                    cur_words, seg_nbits = seg_words(segments[seg_i])
                    cur_words_l = cur_words.tolist()
                    p = 0
                    expected_rst = (expected_rst + 1) % 8
                    mcus_left = restart_interval
                    syms_since = S_TARGET  # force an anchor at segment start
                mcus_left -= 1

        # Anchor policy: block boundary + budget exhausted.
        if (not anchors or syms_since >= S_TARGET or blocks_since >= K_CAP):
            if anchors and len(chunk_ends) < len(anchors):
                max_chunk_syms = max(max_chunk_syms, syms_since)
                chunk_ends.append((p, seg_i))
                chunk_syms.append(syms_since)
            anchors.append((p, seg_i, stream_block, slot))
            syms_since = 0
            blocks_since = 0

        dc_lut = dc_luts[ci]
        ac_lut = ac_luts[ci]
        # DC
        cat, length = decode_sym(p, dc_lut)
        if cat > 11:
            raise PrescanFallback("invalid DC magnitude category")
        p += length + cat
        syms_since += 1
        # AC run
        k = 1
        while k < 64:
            val, length = decode_sym(p, ac_lut)
            s = val & 0x0F
            if s == 0:
                if val == 0xF0:
                    p += length
                    k += 16
                    syms_since += 1
                    continue
                if val != 0:
                    raise PrescanFallback("EOB run in sequential scan")
                p += length
                syms_since += 1
                break
            k += val >> 4
            if k >= 64:
                raise PrescanFallback("coefficient run overshoot")
            p += length + s
            k += 1
            syms_since += 1
        stream_block += 1
        blocks_since += 1

    if anchors and len(chunk_ends) < len(anchors):
        max_chunk_syms = max(max_chunk_syms, syms_since)
        chunk_ends.append((p, seg_i))
        chunk_syms.append(syms_since)
    if max_chunk_syms > S_MAX:
        raise PrescanFallback("chunk symbol budget exceeded")

    # Layout shared bit-for-bit with the C++ prescan: every segment is
    # followed by a fixed 24-byte zero pad (covers the 128-bit overrun bound
    # plus the 8-byte window read), concatenated byte-aligned. Fixed padding
    # makes segment bases computable before the walk — the precondition for
    # the C++ side's parallel per-segment walk.
    seg_bases = []
    out = bytearray()
    for si, seg in enumerate(segments[:seg_i + 1]):
        seg_bases.append(len(out) * 8)
        out.extend(seg)
        out.extend(b"\x00" * 24)

    a_bits = np.array([seg_bases[si] + local_p
                       for (local_p, si, _b, _s) in anchors], np.uint32)
    a_block = np.array([blk for (_p, _si, blk, _s) in anchors], np.int32)
    a_slot = np.array([slot for (_p, _si, _b, slot) in anchors], np.int32)
    a_end = np.array([seg_bases[si] + pe for (pe, si) in chunk_ends], np.uint32)
    a_syms = np.array(chunk_syms, np.int32)
    staged = _attach_meta(_staged_from_layout(
        frame, scan, restart_interval, luts,
        np.frombuffer(bytes(out), np.uint8), a_bits, a_block, a_slot,
        stream_block, a_end, a_syms))

    # Advance the cursor and resolve the trailing marker like _finish_scan.
    cursor.pos = end_pos
    marker = pending

    class _Shim:
        pass

    shim = _Shim()
    shim.marker = marker
    shim.take_marker = lambda: marker
    return _finish_scan(shim, cursor), staged

"""Copy of `jpeg_decoder_tpu/entropy/transcode.py` at commit 0c2d0ea.

Transcode host-decoded coefficient stores into the bits interchange.

Progressive (and quirk-baseline) streams must be entropy-decoded on the host:
EOB runs and refinement passes break the chunk independence the device
Huffman kernel relies on. Round 1 shipped those images' coefficients in the
zigzag-prefix format (~0.9 B/px); this module instead *re-encodes* the final
coefficient store as a sequential-DCT symbol stream in the anchored-chunk
layout the device kernels already consume (entropy/device_scan.py,
entropy/pallas_decode.py) — anchors are emitted during encoding, so no
prescan walk is needed, and the wire cost returns to compressed-stream scale
(~0.3-0.5 B/px). One device format, whatever the source coding process.

The stream uses one synthesized (DC, AC) Huffman table pair shared by every
component — static, so the decode LUTs/compact tables are identical across
images (device-side LUT cache hits; batched grouping by table bytes holds).
The alphabet extends baseline JPEG's: DC categories to 16 and AC sizes to 15
cover any int16 store value except AC == -32768 (vanishingly rare; such
images fall back to the prefix interchange). The device kernels' receive/
extend math (32-bit windows, length + magnitude <= 32) handles these widths
unchanged.

This is an internal interchange, not JPEG: no byte stuffing, no restart
markers, chunk entry points carried out-of-band as anchors. Decode semantics
(F.16 canonical walk + F.12 extend) match the device kernels by construction;
`tests/test_transcode.py` pins store-level bit-exactness against the oracle.
"""

from __future__ import annotations

import functools

import numpy as np

from ..huffman import HuffmanTable
from ..parser import CodingProcess, Predictor, ScanInfo
from .prescan import (
    K_CAP,
    _staged_from_layout,
    _stream_blocks,
    build_decode_lut16,
)
from .scan_python import UNZIGZAG

# Pallas class packing caps chunk byte spans at SLOT_CLASSES[-1] (512); a
# chunk is closed before a block would risk exceeding it. Worst-case block:
# 64 symbols x (16-bit code + 16 magnitude bits) = 256 bytes; +9 bytes of
# window read-ahead past the final symbol.
_MAX_CHUNK_SPAN_BYTES = 512
_WORST_BLOCK_BYTES = 256 + 9

# Symbol target per chunk. Round-4 default was 160 (~87% slot-class fill
# vs ~69% at 96 — a SLOTS-wire economy: overlapping class-padded slot
# copies shrink with fill). On the words/delta wires (default since round
# 3/4) the compressed words ship once and chunk count costs only 4-12
# B/chunk (~0.1% of the wire at 0.26 Mpix), while the kernel's fori_loop
# runs s_max steps per class — 160-symbol chunks bucket to s_max 224 and
# spill into the 256-byte slot class, which round-4 BENCH measured as the
# transcoded-progressive device-resident gap (tower_progressive 1.62 ms vs
# tower 1.37 on identical pixels). Default now matches the prescan's
# anchoring (96 -> s_max <= 176, no 256B class); JPEG_TPU_TRANSCODE_STARGET
# overrides for re-measurement. Ceiling either way: target - 1 + one
# block's 64-symbol overshoot <= the 224 device step budget.
import os as _os

try:
    S_TARGET_TC = int(_os.environ.get("JPEG_TPU_TRANSCODE_STARGET") or 96)
except ValueError:
    S_TARGET_TC = 96


def _limited_code_lengths(freqs: "list[int]", max_len: int = 16) -> "list[int]":
    """Huffman code lengths from frequencies, limited to `max_len` bits via
    the JPEG Annex K.2 BITS-adjustment (jpeglib jpeg_gen_optimal_table's
    shape, without the reserved all-ones slot — chunk budgets, not padding,
    terminate device decode)."""
    import heapq

    n = len(freqs)
    if n == 1:
        return [1]
    heap = [(max(1, f), i, (i,)) for i, f in enumerate(freqs)]
    heapq.heapify(heap)
    depth = [0] * n
    tick = n
    while len(heap) > 1:
        fa, _, sa = heapq.heappop(heap)
        fb, _, sb = heapq.heappop(heap)
        for s in sa + sb:
            depth[s] += 1
        heapq.heappush(heap, (fa + fb, tick, sa + sb))
        tick += 1

    bits = [0] * 64
    for d in depth:
        bits[d] += 1
    for i in range(63, max_len, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1

    # Canonical reassignment: symbols ordered by (original depth, frequency
    # desc, symbol) take the adjusted lengths shortest-first.
    order = sorted(range(n), key=lambda s: (depth[s], -freqs[s], s))
    lengths = [0] * n
    k = 0
    for ln in range(1, max_len + 1):
        for _ in range(bits[ln]):
            lengths[order[k]] = ln
            k += 1
    return lengths


def _bits_values_from_lengths(symbols: "list[int]",
                              lengths: "list[int]") -> "tuple[list, bytes]":
    """(BITS[16], values) in canonical order (length asc, symbol order as
    given within a length) — the DHT wire convention HuffmanTable.build
    expects."""
    bits = [0] * 16
    by_len: dict = {}
    for sym, ln in zip(symbols, lengths):
        bits[ln - 1] += 1
        by_len.setdefault(ln, []).append(sym)
    values = []
    for ln in range(1, 17):
        values.extend(by_len.get(ln, ()))
    return bits, bytes(values)


# Symbol frequencies measured over the reftest corpus stores plus
# photographic progressive content at q75/q85/q92 (scaled /8, floor 1). The
# resulting static tables land within ~1% of the per-corpus entropy bound —
# per-image optimal tables would shave only that last percent while breaking
# cross-image LUT caching and batched grouping, so static wins.
_DC_FREQ = (1353, 1010, 1195, 1320, 994, 511, 280, 146, 56, 11, 4, 1, 1, 1,
            1, 1, 1)
_AC_EOB_FREQ = 6404
_AC_ZRL_FREQ = 584
_AC_FREQ = (   # [run][size-1]
    (31730, 17541, 7617, 2466, 823, 366, 196, 45, 3, 1, 1, 1, 1, 1, 1),
    (11353, 3316, 738, 127, 23, 7, 8, 2, 1, 1, 1, 1, 1, 1, 1),
    (5288, 843, 100, 16, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
    (2850, 281, 27, 3, 3, 5, 4, 1, 1, 1, 1, 1, 1, 1, 1),
    (1657, 105, 6, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
    (1066, 40, 2, 1, 2, 3, 5, 1, 1, 1, 1, 1, 1, 1, 1),
    (737, 19, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
    (526, 11, 1, 2, 4, 4, 1, 1, 1, 1, 1, 1, 1, 1, 1),
    (391, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
    (323, 3, 2, 1, 4, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1),
    (257, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
    (196, 3, 3, 4, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
    (161, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
    (132, 2, 3, 3, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
    (119, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
    (92, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
)


@functools.lru_cache(maxsize=1)
def transcode_tables() -> "tuple[HuffmanTable, HuffmanTable]":
    """The static (DC, AC) pair used by every transcoded stream."""
    dc_syms = list(range(17))
    dc_lens = _limited_code_lengths(list(_DC_FREQ))
    dc_bits, dc_vals = _bits_values_from_lengths(dc_syms, dc_lens)
    dc_table = HuffmanTable.build(dc_bits, dc_vals, is_ac=False)

    ac_syms = [0x00, 0xF0]          # EOB, ZRL
    ac_freq = [_AC_EOB_FREQ, _AC_ZRL_FREQ]
    for r in range(16):
        for s in range(1, 16):
            ac_syms.append((r << 4) | s)
            ac_freq.append(_AC_FREQ[r][s - 1])
    ac_lens = _limited_code_lengths(ac_freq)
    ac_bits, ac_vals = _bits_values_from_lengths(ac_syms, ac_lens)
    ac_table = HuffmanTable.build(ac_bits, ac_vals, is_ac=True)
    return dc_table, ac_table


@functools.lru_cache(maxsize=1)
def _encode_luts() -> "tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]":
    """(dc_code, dc_len, ac_code, ac_len) encoder lookup arrays indexed by
    symbol value (DC: category 0..16; AC: (run<<4)|size byte)."""
    dc_table, ac_table = transcode_tables()

    def codes_of(table, n_syms):
        code = np.zeros(n_syms, np.uint32)
        length = np.zeros(n_syms, np.uint8)
        # Rebuild canonical (code, len) per value from maxcode/delta
        # (Annex C, same derivation build_decode_lut16 uses).
        j = 0
        c = 0
        for L in range(1, 17):
            if table.maxcode[L - 1] < 0:
                continue
            mincode = j - int(table.delta[L - 1])
            count = int(table.maxcode[L - 1]) - mincode + 1
            for k in range(count):
                v = int(table.values[j + k])
                code[v] = mincode + k
                length[v] = L
            j += count
        return code, length

    dc_code, dc_len = codes_of(dc_table, 17)
    ac_code, ac_len = codes_of(ac_table, 256)
    return dc_code, dc_len, ac_code, ac_len


class _BitWriter:
    """MSB-first bit accumulator (no byte stuffing — internal format)."""

    __slots__ = ("buf", "acc", "nbits")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, value: int, count: int) -> None:
        if count == 0:
            return
        self.acc = (self.acc << count) | (value & ((1 << count) - 1))
        self.nbits += count
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def bitpos(self) -> int:
        return len(self.buf) * 8 + self.nbits

    def finish(self) -> bytes:
        if self.nbits:
            self.buf.append((self.acc << (8 - self.nbits)) & 0xFF)
            self.acc = 0
            self.nbits = 0
        return bytes(self.buf)


class TranscodeFallback(Exception):
    """Store holds a value the symbol alphabet cannot encode."""


def _category(v: int) -> int:
    return int(v).bit_length() if v >= 0 else int(-v).bit_length()


def _check_covered(frame, scan, stores16: "list[np.ndarray]") -> None:
    """Blocks outside the decoded-MCU grid (the reference's `mcu*8 >= image`
    clip, _stream_blocks) are not transported; the assembler zero-fills them.
    They are never rendered and hold zeros in any stream the reference itself
    produced — but a store that somehow has data there cannot round-trip, so
    defer it to the prefix interchange. The covered region per component is a
    rectangle: the walk visits exactly by < rows*vs, bx < cols*hs."""
    components = [frame.components[i] for i in scan.component_indices]
    interleaved = len(components) > 1
    w, h = frame.image_size.width, frame.image_size.height
    if interleaved:
        max_x, max_y = frame.mcu_size.width, frame.mcu_size.height
    else:
        max_x = components[0].block_size.width
        max_y = components[0].block_size.height
    cols = min(max_x, (w + 7) // 8)
    rows = min(max_y, (h + 7) // 8)
    for c, st in zip(components, stores16):
        hs = c.horizontal_sampling_factor if interleaved else 1
        vs = c.vertical_sampling_factor if interleaved else 1
        grid = st.reshape(c.block_size.height, c.block_size.width, 64)
        if (grid[rows * vs:].any() or grid[:, cols * hs:].any()):
            raise TranscodeFallback("nonzero coefficients outside MCU grid")


def _python_encode(frame, scan, stores16, dc_code, dc_len, ac_code, ac_len):
    """Pure-Python mirror of entropy.cc jt_transcode_scan (bit-identical)."""
    ncomp = len(frame.components)
    zz = np.asarray(UNZIGZAG)
    comp_zz = [np.ascontiguousarray(s.reshape(-1, 64)[:, zz].astype(np.int32))
               for s in stores16]
    bw = [c.block_size.width for c in frame.components]

    w = _BitWriter()
    a_bits: list = []
    a_block: list = []
    a_slot: list = []
    c_end: list = []
    c_syms: list = []
    preds = [0] * ncomp
    syms_since = 0
    blocks_since = 0
    block_i = 0

    def close_chunk() -> None:
        if a_bits and len(c_end) < len(a_bits):
            c_end.append(w.bitpos())
            c_syms.append(syms_since)

    for comp, by, bx, _mcu, slot in _stream_blocks(frame, scan):
        p = w.bitpos()
        if (not a_bits or syms_since >= S_TARGET_TC or blocks_since >= K_CAP
                or (p // 8 - a_bits[-1] // 8) + _WORST_BLOCK_BYTES
                > _MAX_CHUNK_SPAN_BYTES):
            close_chunk()
            a_bits.append(p)
            a_block.append(block_i)
            a_slot.append(slot)
            syms_since = 0
            blocks_since = 0

        row = comp_zz[comp][by * bw[comp] + bx]

        # DC: wrap16 diff against the component predictor (the assembler
        # recovers DC via int32 cumsum truncated to int16).
        dc = int(row[0])
        diff = ((dc - preds[comp] + 0x8000) & 0xFFFF) - 0x8000
        preds[comp] = dc
        cat = _category(diff)
        ln = int(dc_len[cat])
        if ln == 0:
            raise TranscodeFallback(f"DC category {cat} unencodable")
        if diff < 0:
            w.put((int(dc_code[cat]) << cat) | ((diff + (1 << cat) - 1)
                                                & ((1 << cat) - 1)), ln + cat)
        else:
            w.put((int(dc_code[cat]) << cat) | diff, ln + cat)
        syms_since += 1

        nz = np.flatnonzero(row[1:]) + 1
        prev = 0
        for k in nz:
            v = int(row[k])
            run = int(k) - prev - 1
            prev = int(k)
            while run >= 16:
                w.put(int(ac_code[0xF0]), int(ac_len[0xF0]))
                syms_since += 1
                run -= 16
            s = _category(v)
            if s > 15:
                raise TranscodeFallback("AC magnitude exceeds 15 bits")
            sym = (run << 4) | s
            ln = int(ac_len[sym])
            mbits = v if v > 0 else v + (1 << s) - 1
            w.put((int(ac_code[sym]) << s) | (mbits & ((1 << s) - 1)), ln + s)
            syms_since += 1
        if prev != 63:
            w.put(int(ac_code[0]), int(ac_len[0]))   # EOB
            syms_since += 1

        blocks_since += 1
        block_i += 1

    close_chunk()
    out = w.finish() + b"\x00" * 16   # window read-ahead past the last symbol
    return (np.frombuffer(out, np.uint8), np.asarray(a_bits, np.uint32),
            np.asarray(a_block, np.int32), np.asarray(a_slot, np.int32),
            np.asarray(c_end, np.uint32), np.asarray(c_syms, np.int32),
            block_i)


def transcode_scan(frame, stores: "list[np.ndarray]"):
    """Encode per-component natural-order stores ([blocks*64] int16) into an
    AnchoredScan. Returns (scan, staged); raises TranscodeFallback when a
    value exceeds the alphabet (AC -32768 / categories past 16)."""
    from .prescan import _prescan_geometry
    from .native import get_native

    ncomp = len(frame.components)
    scan = ScanInfo(
        component_indices=list(range(ncomp)),
        dc_table_indices=[0] * ncomp,
        ac_table_indices=[0] * ncomp,
        spectral_selection_start=0,
        spectral_selection_end=64,
        predictor_selection=Predictor(0),
        successive_approximation_high=0,
        successive_approximation_low=0,
        point_transform=0,
    )
    stores16 = [np.asarray(s, np.int16).reshape(-1) for s in stores]
    _check_covered(frame, scan, stores16)
    dc_code, dc_len, ac_code, ac_len = _encode_luts()

    native = get_native()
    res = None
    if native is not None and hasattr(native, "transcode_scan") and ncomp <= 4:
        geometry = _prescan_geometry(frame, scan, 0)
        geometry["interleaved"] = 1 if ncomp > 1 else 0
        geometry["comp_bw"] = [c.block_size.width for c in frame.components]
        geometry["comp_hs"] = [c.horizontal_sampling_factor
                               for c in frame.components]
        geometry["comp_vs"] = [c.vertical_sampling_factor
                               for c in frame.components]
        offs = np.cumsum([0] + [s.size for s in stores16])
        geometry["comp_off"] = [int(o) for o in offs[:-1]]
        res = native.transcode_scan(
            np.concatenate(stores16), geometry,
            dc_code, dc_len, ac_code, ac_len,
            S_TARGET_TC, K_CAP, _MAX_CHUNK_SPAN_BYTES, _WORST_BLOCK_BYTES)
        if res is None:
            raise TranscodeFallback("native transcode fallback")
    if res is None:
        res = _python_encode(frame, scan, stores16,
                             dc_code, dc_len, ac_code, ac_len)
    out, a_bits, a_block, a_slot, c_end, c_syms, block_i = res

    dc_table, ac_table = transcode_tables()
    luts = np.concatenate(
        [np.stack([build_decode_lut16(dc_table),
                   build_decode_lut16(ac_table)])] * ncomp)
    staged = _staged_from_layout(
        frame, scan, 0, luts, np.asarray(out, np.uint8),
        np.asarray(a_bits, np.uint32), np.asarray(a_block, np.int32),
        np.asarray(a_slot, np.int32), block_i,
        np.asarray(c_end, np.uint32), np.asarray(c_syms, np.int32))

    def _pack_values(tab) -> np.ndarray:
        v = np.zeros(256, np.uint8)
        v[:len(tab.values)] = tab.values
        ww = v.reshape(64, 4).astype(np.uint32)
        return ww[:, 0] | (ww[:, 1] << 8) | (ww[:, 2] << 16) | (ww[:, 3] << 24)

    staged.tab_maxcode = np.stack([dc_table.maxcode.astype(np.int32),
                                   ac_table.maxcode.astype(np.int32)])
    staged.tab_delta = np.stack([dc_table.delta.astype(np.int32),
                                 ac_table.delta.astype(np.int32)])
    staged.tab_values = np.stack([_pack_values(dc_table),
                                  _pack_values(ac_table)])
    staged.comp_to_upair = (0,) * ncomp
    return scan, staged


def transcode_decoded(decoder, precision: str = "fast"):
    """Build a StagedBits from an already-host-decoded Decoder, or None when
    the image is outside the transcoder's domain (non-DCT frame, missing
    components, unencodable values, empty plan)."""
    from ..ops.pipeline import geometry_from_frame
    from ..staging import StagedBits

    frame = decoder.frame
    if frame is None or frame.coding_process == CodingProcess.LOSSLESS:
        return None
    n = len(frame.components)
    if n == 0 or any(i not in decoder._pending_render for i in range(n)):
        return None
    stores = [np.asarray(decoder._pending_render[i][0]).reshape(-1)
              for i in range(n)]
    if any(s.size == 0 or s.size % 64 for s in stores):
        return None
    try:
        scan, staged = transcode_scan(frame, stores)
    except TranscodeFallback:
        return None
    if staged.n_items == 0:
        return None

    qts = tuple(decoder._pending_render[i][1] for i in range(n))
    transform = None if n == 1 else decoder._determine_color_transform()
    geometry = geometry_from_frame(frame, transform, precision=precision)
    kept = tuple((i, i) for i in range(n))
    info = decoder.info()
    return StagedBits(geometry, ((staged, kept),), qts,
                      info.width * info.height / 1e6)

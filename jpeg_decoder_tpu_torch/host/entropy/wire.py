"""Copy of the host packers of `jpeg_decoder_tpu/entropy/pallas_decode.py`
at commit 0c2d0ea: the 4 B/chunk delta wire (`pack_delta`,
`pack_delta_meta_np`, `WORDS_PAD`, `DELTA_BITS`) and the constants they
read (`:41-44`, `:72-108`, `:233-243`, `:422-570`). The Pallas kernel of
that module is not copied; the port's kernel K1
(`entropy/chunk_decode.py::decode_chunks`) takes its place. The slot and
words wires and the batched merge packers are not copied either.
"""

from __future__ import annotations

import numpy as np

from .prescan import AnchoredScan

SLOT_CLASSES = (32, 48, 64, 96, 128, 256, 512)   # slot bytes
SYM_BUCKETS = (32, 64, 96, 128, 176, 224)
MAX_TABS = 4                          # <= 2 distinct (dc, ac) pairs


def _class_collapse_enabled() -> bool:
    """Single-class packing (see pack_classes/pack_delta): every chunk of
    a scan goes in the single widest REQUIRED slot class. The slot-class
    machinery was a wire-size economy for the round-2 slots wire; on the
    words/delta wires (stream shipped once) it only splits the kernel into
    per-class launches with padded last tiles — and the collapsed
    s_max_max run measured FASTER at every scale on v5e (2026-08-20/21
    A/Bs, delta wire solo): tower 0.26 Mpix 1.377 -> 0.855 ms (1.61x),
    rgb 0.17 Mpix 1.227 -> 0.890 (1.38x), 0.39 Mpix synth 1.447 -> 1.238
    (1.17x), large_image 3.43 Mpix 5.147 -> **4.329 ms = 792 Mpix/s**
    (1.19x; 13k chunks, so this is not just launch overhead — full tiles
    and one program beat five partially-padded classes). The prescan
    bounds every chunk at S_MAX=162 symbols, so the collapsed step count
    never exceeds the 176 bucket. Default ON; JPEG_TPU_CLASS_COLLAPSE=0
    restores the span classes."""
    import os
    return os.environ.get("JPEG_TPU_CLASS_COLLAPSE", "1") not in ("0",
                                                                  "off")


# Chunk-count ceiling for collapse: effectively unlimited (measured winning
# at 13k chunks); JPEG_TPU_COLLAPSE_MAX tunes for re-measurement.
import os as _os

try:
    COLLAPSE_MAX = int(_os.environ.get("JPEG_TPU_COLLAPSE_MAX") or (1 << 30))
except ValueError:
    COLLAPSE_MAX = 1 << 30


def _bucket_items(n: int) -> int:
    """1024-granular bucket with 1.3x geometric steps (pow2 wastes up to 2x
    in kernel lane-slots; tiles are 1024 items)."""
    size = 1024
    while size < n:
        size = -(-int(size * 1.3) // 1024) * 1024
    return size


WORDS_PAD = SLOT_CLASSES[-1] // 4 + 1   # row-gather slack: max slot_words + 1


def _bucket_words(n: int) -> int:
    """Word-count buckets for the wire: finer-grained than the 1.3x staging
    bucket because these bytes ride the throttled link — but each distinct
    padded length keys a fresh compile of the whole fused pipeline, so the
    step is a compromise (1.125x: ~6% mean zero-pad, half the executables
    of the 1.0625x it replaced)."""
    from .prescan import _bucket_up
    return _bucket_up(n, floor=1024, factor=1.125)


DELTA_BITS = 23   # anchor-bit delta field of the 4 B/chunk wire


def pack_delta(staged: AnchoredScan):
    """wire="delta": 4 B/chunk metadata — ONE uint32 per chunk, in stream
    order: anchor-bit delta (23b) | block budget (5b) | entry slot (4b).
    The device reconstructs everything else with vector ops
    (build_pallas_sweep): absolute anchor bits = cumsum of deltas, block
    bases = exclusive cumsum of budgets (chunks partition the scan's
    blocks), slot-size class membership from the span implied by the NEXT
    delta, and the per-class stream-ordered partition with one stable
    argsort + row gather. Halves the words-packed chunk metadata — the
    sustained H2D metric tracks wire bytes 1:1 (BASELINE.md).

    Returns ((words, dm, cnts), shapes) or None when the scan is
    Pallas-ineligible or any field would overflow (callers degrade to the
    words-packed wire): words int32 [bucketed] — the compressed stream;
    dm int32 [n_pad] — the per-chunk words, entry n = a budget-0
    terminator carrying the closing delta (the last real chunk's span),
    then zeros; cnts int32 [n_classes] — per-class real-item counts
    (runtime values; the bucketed shapes are the static compile key).
    shapes: ((slot_words, s_max, n_bucket, n_items), ...) ascending class.
    """
    if staged.chunk_end is None or staged.tab_maxcode is None:
        return None
    if len(staged.tab_maxcode) > MAX_TABS:
        return None
    n = staged.n_items
    if n == 0:
        return None
    if staged.n_words >= (1 << 26):
        # Absolute anchor bits must fit the device's int32 cumsum (the
        # prescan's own uint32 guard allows scans up to 512 MB).
        return None

    from .native import get_native
    native = get_native()
    if native is not None and hasattr(native, "pack_delta_meta"):
        dm_head = np.empty(n + 1, np.uint32)
        res = native.pack_delta_meta(
            staged.anchor_bits[:n], staged.anchor_block[:n + 1],
            staged.anchor_slot[:n], staged.chunk_end[:n],
            staged.chunk_syms[:n], n, dm_head)
        if res is None:
            return None
        cls_count, cls_maxsyms = res
    else:
        out = pack_delta_meta_np(staged)
        if out is None:
            return None
        dm_head, cls_count, cls_maxsyms = out

    if _class_collapse_enabled() and n <= COLLAPSE_MAX:
        # Small-scan collapse (see pack_classes): one class = one grid-1
        # kernel launch. The device partition skips the span rule when a
        # single class is present (unpack_delta_classes), so host and
        # device agree by construction.
        top = max(ci for ci in range(len(SLOT_CLASSES)) if cls_count[ci])
        ms = max(int(cls_maxsyms[ci]) for ci in range(len(SLOT_CLASSES)))
        if ms > SYM_BUCKETS[-1]:
            return None
        s_max = next(b for b in SYM_BUCKETS if ms <= b)
        cls_count = [0] * len(SLOT_CLASSES)
        cls_count[top] = n
        cls_maxsyms = [0] * len(SLOT_CLASSES)
        cls_maxsyms[top] = ms

    shapes = []
    cnts = []
    cum = 0
    max_need = 0
    for ci, cbytes in enumerate(SLOT_CLASSES):
        cnt = int(cls_count[ci])
        if cnt == 0:
            continue
        ms = int(cls_maxsyms[ci])
        if ms > SYM_BUCKETS[-1]:
            return None
        s_max = next(b for b in SYM_BUCKETS if ms <= b)
        nb = _bucket_items(cnt)
        shapes.append((cbytes // 4, s_max, nb, cnt))
        cnts.append(cnt)
        max_need = max(max_need, cum + nb)
        cum += cnt
    # dm must cover the terminator AND every class's [off, off + nb)
    # dynamic-slice window (padded tails read dead rows, masked on device).
    n_pad = _bucket_items(max(n + 1, max_need))
    dm = np.empty(n_pad, np.uint32)
    dm[:n + 1] = dm_head
    dm[n + 1:] = 0
    nw = staged.n_words
    wpad = np.empty(_bucket_words(nw + WORDS_PAD), np.uint32)
    wpad[:nw] = staged.words[:nw]
    wpad[nw:] = 0
    return ((wpad.view(np.int32), dm.view(np.int32),
             np.asarray(cnts, np.int32)), tuple(shapes))


def pack_delta_meta_np(staged: AnchoredScan):
    """Numpy mirror of entropy.cc jt_pack_delta (the ABI-15 one-pass native
    emitter): the per-chunk u32 words incl. terminator plus per-class
    (count, max symbols). Byte-identical outputs (differentially tested) —
    the fallback when the native library is unavailable and the oracle the
    native pass is pinned against. Returns (dm[n+1] uint32, cls_count[8],
    cls_syms[8]) or None on fallback."""
    n = staged.n_items
    ab = staged.anchor_bits[:n].astype(np.int64)
    end_last = int(staged.chunk_end[:n][-1])
    budgets = (staged.anchor_block[1:n + 1]
               - staged.anchor_block[:n]).astype(np.int64)
    slot0 = staged.anchor_slot[:n].astype(np.int64)
    d = np.empty(n + 1, np.int64)
    d[0] = ab[0]
    d[1:n] = ab[1:] - ab[:-1]
    d[n] = end_last - ab[-1]
    if d.min() < 0 or d.max() >= (1 << DELTA_BITS):
        return None
    if budgets.min() < 1 or budgets.max() > 31 \
            or slot0.min() < 0 or slot0.max() > 15:
        return None
    if int(staged.anchor_block[0]) != 0:
        # Device bases come from the budget cumsum, which assumes chunk 0
        # starts at block 0.
        return None
    # Span EXACTLY as the device computes it: from consecutive anchor
    # deltas, not chunk_end — for non-final chunks the next anchor can sit
    # past this chunk's last symbol (restart gaps), which only widens the
    # window (a chunk may land one class up; both sides agree).
    span = ((ab + d[1:]) >> 3) - (ab >> 3) + 9
    if span.max() > SLOT_CLASSES[-1]:
        return None
    # The delta-implied window must cover every chunk's true symbol span
    # (the kernel reads up to chunk_end + 8 bytes); violated only if a
    # chunk's recorded end ran PAST the next anchor — degrade, don't risk.
    true_span = (staged.chunk_end[:n].astype(np.int64) >> 3) - (ab >> 3) + 9
    if (span < true_span).any():
        return None
    syms = staged.chunk_syms[:n]
    cls_idx = np.searchsorted(np.asarray(SLOT_CLASSES), span)
    cls_count = np.bincount(cls_idx, minlength=8).astype(np.int32)
    cls_syms = np.zeros(8, np.int32)
    np.maximum.at(cls_syms, cls_idx, syms)
    dm = np.empty(n + 1, np.uint32)
    dm[:n] = ((d[:n].astype(np.uint32) << 9)
              | (budgets.astype(np.uint32) << 4)
              | slot0.astype(np.uint32))
    dm[n] = d[n].astype(np.uint32) << 9   # terminator: budget 0 = dead
    return dm, cls_count, cls_syms

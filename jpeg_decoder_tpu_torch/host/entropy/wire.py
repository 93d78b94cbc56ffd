"""Copy of the host packers of `jpeg_decoder_tpu/entropy/pallas_decode.py`
at commit 0c2d0ea: the 4 B/chunk delta wire (`pack_delta`,
`pack_delta_meta_np`, `WORDS_PAD`, `DELTA_BITS`), its batch merge
(`merge_image_packs_delta`) and the constants they read (`:41-44`,
`:72-108`, `:233-243`, `:422-655`). The Pallas kernel of that module is
not copied; the port's kernel K1 (`entropy/chunk_decode.py::decode_chunks`)
takes its place. The slot and words wires and their merges
(`merge_image_packs`, `merge_image_packs_words`) are not copied: the port
has neither wire. In their place `merge_anchor_wires` is the port's own
merge of its 12 B/chunk anchor wire (`models/stream.py::_anchor_scan`),
and `anchor_meta` packs that wire's meta word (the image's, and a
stripe's, `parallel/stripe_bits.py::stripe_wire`).
"""

from __future__ import annotations

import numpy as np

from ..errors import FormatError
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


def merge_image_packs_delta(entries, nb_image):
    """wire="delta" merge: per-image word streams concatenate (each keeps
    its gather pad); the per-chunk delta arrays concatenate with each
    image's FIRST delta rebased to the absolute gap from the previous
    image's terminator (word offsets are whole words, so every span — and
    with it the class partition and counts — is invariant). Block bases
    need no explicit offsets at all: each image's budgets sum to its block
    count, so the device's global budget cumsum lands image i's chunks at
    its cumulative block offset by construction. `nb_image` is accepted
    for signature parity with the other merges and only sanity-checked.

    Returns ((words, dm, cnts), shapes) or None on delta overflow at an
    image boundary / oversize merged stream (callers degrade the group to
    the words-packed merge).

    Class collapse (pack_delta under JPEG_TPU_CLASS_COLLAPSE): a collapsed
    input's host counts do NOT follow the span rule the merged device
    partition re-derives, so merging them under span classes decodes
    garbage. All-single-class inputs (collapsed or genuinely one-class)
    merge into ONE union class — the device's single-class shortcut keeps
    stream order, matching the summed counts for either kind. A mix of
    single- and multi-class inputs is declined when the single-class ones
    could be collapsed (callers decode those images singly)."""
    word_total = sum(len(e[0][0]) for e in entries)
    if word_total >= (1 << 26):
        # Absolute anchor bits must fit the device's int32 cumsum.
        return None
    single = [len(shapes) == 1 for (_c, shapes) in entries]
    collapse_merge = all(single)
    if not collapse_merge and any(
            s and _class_collapse_enabled() and shapes[0][3] <= COLLAPSE_MAX
            for s, (_c, shapes) in zip(single, entries)):
        return None
    per_class: dict = {}
    dm_parts = []
    word_off = 0
    prev_end = 0
    words_parts = []
    total_real = 0
    for (words, dm, cnts), shapes in entries:
        dmu = dm.view(np.uint32)
        n = int(cnts.sum())
        d = (dmu[:n + 1] >> 9).astype(np.int64)
        rest = dmu[:n + 1] & 0x1FF
        first_abs = d[0] + word_off * 32
        d0 = first_abs - prev_end
        if d0 < 0 or d0 >= (1 << DELTA_BITS):
            return None
        dd = d.copy()
        dd[0] = d0
        dm_parts.append(((dd.astype(np.uint32) << 9)
                         | rest.astype(np.uint32)))
        prev_end = first_abs + int(d[1:].sum())
        total_real += n
        for (sw, sm, _nb, ni) in shapes:
            key = 0 if collapse_merge else sw
            c0, s0, w0 = per_class.get(key, (0, 0, 0))
            per_class[key] = (c0 + ni, max(s0, sm), max(w0, sw))
        words_parts.append(words)
        word_off += len(words)

    shapes_out = []
    cnts_out = []
    cum = 0
    max_need = 0
    for key in sorted(per_class):
        cnt, sm, sw_max = per_class[key]
        sw = sw_max if collapse_merge else key
        nb = _bucket_items(cnt)
        shapes_out.append((sw, sm, nb, cnt))
        cnts_out.append(cnt)
        max_need = max(max_need, cum + nb)
        cum += cnt
    dm_real = np.concatenate(dm_parts)
    n_pad = _bucket_items(max(len(dm_real), max_need))
    dm_all = np.zeros(n_pad, np.uint32)
    dm_all[:len(dm_real)] = dm_real
    wcat = np.zeros(_bucket_words(word_off), np.int32)
    pos = 0
    for w in words_parts:
        wcat[pos:pos + len(w)] = w
        pos += len(w)
    return ((wcat, dm_all.view(np.int32), np.asarray(cnts_out, np.int32)),
            tuple(shapes_out))


def anchor_meta(budget, slot) -> np.ndarray:
    """The anchor wire's per-chunk meta word, `budget << 4 | slot` (int32),
    from int64 budgets (blocks a chunk decodes) and MCU-pattern slots.
    Raises FormatError when a field does not fit: a budget outside 0-31 or
    a slot outside 0-15."""
    budget = np.asarray(budget, np.int64)
    slot = np.asarray(slot, np.int64)
    if budget.size and (budget.min() < 0 or budget.max() > 31
                        or slot.min() < 0 or slot.max() > 15):
        raise FormatError("chunk budget or slot outside the anchor wire's "
                          "fields")
    return (budget << 4 | slot).astype(np.int32)


def merge_anchor_wires(entries):
    """The port's own merge of its 12 B/chunk anchor wire
    (`models/stream.py::_anchor_scan`), the counterpart of the 12 B branch
    of `merge_image_packs_words` (`pallas_decode.py:344`). entries: per
    image (words, dm, ab, base, n_blocks). The word streams concatenate,
    each followed by WORDS_PAD zero words, so every chunk reads the same
    bits past its image's end as it does alone (zeros); each image's `ab`
    gains 32 x its word offset (uint32 arithmetic), its `base` the blocks
    of the images before it; `dm` (budget << 4 | slot) stays as it is.
    Returns (words, dm, ab, base), int32 each, or None when the merged
    stream reaches 2^26 words (entry bits must stay below 2^31)."""
    sizes = [len(e[0]) + WORDS_PAD for e in entries]
    if sum(sizes) >= (1 << 26):
        return None
    word_off = np.cumsum([0] + sizes)[:-1]
    block_off = np.cumsum([0] + [int(e[4]) for e in entries])[:-1]
    words = np.zeros(sum(sizes), np.int32)
    for (w, *_rest), off in zip(entries, word_off):
        words[off:off + len(w)] = w
    dm = np.concatenate([e[1] for e in entries]).astype(np.int32)
    ab = np.concatenate([
        (np.asarray(e[2]).view(np.uint32) + np.uint32(32 * off))
        for e, off in zip(entries, word_off)]).view(np.int32)
    base = np.concatenate([np.asarray(e[3], np.int64) + off
                           for e, off in zip(entries, block_off)])
    return words, dm, ab, base.astype(np.int32)

"""Port of `jpeg_decoder_tpu/parallel/stripe_bits.py`: one image's device
entropy decode, assembly and reconstruction across the mesh's "stripe"
axis.

Anchored chunks are independent by construction, so the image's MCU rows
split into contiguous stripes whose chunks each device Huffman-decodes,
assembles and reconstructs locally. The couplings between stripes, and
how they close:
- **The DC predictor chain** (`/root/reference/src/decoder.rs:1102-1118`):
  kernel K1 emits stream-ordered DC differences, so a stripe's absolute
  DC is its local prefix sum plus the sum of every earlier stripe's
  differences: one value per stripe and component, `mesh.exclusive_carry`
  of `entropy/assemble.py::dc_totals` (the reference's all_gather in
  `device_scan._dc_carry`). Restart-interval streams carry nothing: the
  splitter accepts them only when the restart segments lie inside the
  stripes, so every DC reset is stripe-local.
- **The chunk straddling a stripe's entry**: anchors fall every ~K_CAP
  blocks, not on MCU-row boundaries, so stripe d's first chunk is the last
  one anchored at or before its first block. Its lead-in blocks belong to
  stripe d-1, which decodes the same chunk as its tail (less than one
  chunk of duplicate work per seam): its rebased first block is negative,
  and K1 drops the stores outside the stripe (the kernel's row guard, and
  the plain version's `blk_abs >= 0`).
- **The V2 chroma halo** (`/root/reference/src/upsampler.rs:174-177`):
  `stripes.build_stripe_local_recon`.

Host half, copied from the reference (`StripeSplit`, `_stripe_ranges`,
`split_anchored_stripes`, `stripe_bits.py:50-191`) on the host copy's
prescan (`AnchoredScan`, `_plan_for`, `_bucket_up`) and parser
(`Dimensions`, `update_component_sizes`), without `_pack_stripes_words`
and the split's `pallas` field: those build the Pallas words wire, and K1
reads the anchor wire, so the port has one engine (the reference's XLA
one, `engine="xla"`). The split also records what the per-stripe launch
needs: each stripe's real chunk count, words and symbol bound.

Device half (`stripe_body`): per stripe, on its device, the 12 B/chunk
anchor wire (`stripe_wire`: the stripe's words, `budget << 4 | slot` with
the last real chunk's budget stopping at the stripe's real block extent,
entry bits rebased to the words, first blocks rebased, the straddler's
negative), K1 over the stripe's blocks of each image into its rows of one
nat a stripe, the DC totals (kernel D1), assembly with the carry of every
earlier stripe, then the halo'd exact reconstruction.

Dispatch: a line of stripes on one device (`graphs.one_device`: its
stripes and the device its rows gather on, in a mesh of one process; so
every line of the slots of one card) is one CUDA graph per
`graphs.stripes_key` in the process's cache of that device
(`graphs.device_graphs`), the counterpart of the JAX package's
`_compiled_stripe_bits_xla{,_batch}`: its images' stripe wires, padded to
the split's word and chunk buckets (`padded_stripe_wire`, K1 at the
plan's step bound), and their tables land in the graph's arena in one H2D
copy, and the whole line (K1, D1, the carry, A1, E1, the halo, T1, the
gather) replays, from the key's second call (its first dispatches
eagerly). Any other line, and a key's first call, dispatches eagerly
(`_decode_stripes`): each stripe its real chunk count, a `put` per stripe
and image.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ..entropy.assemble import assemble_nat, dc_totals
from ..entropy.chunk_decode import decode_chunks
from ..host.entropy.prescan import (AnchoredScan, ScanPlan, _bucket_up,
                                    _plan_for)
from ..host.entropy.wire import WORDS_PAD, anchor_meta
from ..host.parser import Dimensions, update_component_sizes
from ..models import graphs
from ..transfer import put
from .dist import Shard
from .mesh import exclusive_carry, gather_rows, local_positions
from .stripes import build_stripe_local_recon


@dataclasses.dataclass
class StripeSplit:
    """One scan partitioned into per-stripe sub-scans (uniform layout)."""
    plan: ScanPlan            # per-stripe plan (shared by every stripe)
    n_stripes: int
    mcu_rows: int             # full-image decoded MCU rows
    k_mcu: int                # MCU rows per stripe
    n_blocks_local: int
    # The reference's XLA-engine arrays, stacked on a leading stripe axis:
    words: np.ndarray         # uint32 [n, Wb]
    anchor_bits: np.ndarray   # uint32 [n, I]
    anchor_block: np.ndarray  # int32  [n, I + 1]
    anchor_slot: np.ndarray   # int32  [n, I]
    luts: np.ndarray
    tabs: tuple = None        # (maxcode, delta, values) or None
    comp_to_upair: tuple = None
    # Per stripe, for its launch: real chunks, words they read, and the
    # most symbol steps any of them takes.
    n_items: tuple = ()
    n_words: tuple = ()
    s_max: tuple = ()


def _stripe_ranges(blk, n_items, nb_local, n_stripes, n_blocks_real):
    """Per-stripe chunk index ranges [i0, i1): i0 = last chunk anchored
    at-or-before the stripe's first block (the straddler), i1 = first chunk
    anchored at-or-after the stripe end."""
    ranges = []
    for d in range(n_stripes):
        b0 = d * nb_local
        if b0 >= n_blocks_real or n_items == 0:
            ranges.append((0, 0))
            continue
        b1 = b0 + nb_local
        i0 = int(np.searchsorted(blk[:n_items], b0, side="right")) - 1
        i0 = max(i0, 0)
        i1 = int(np.searchsorted(blk[:n_items], b1, side="left"))
        ranges.append((i0, i1))
    return ranges


def split_anchored_stripes(staged: AnchoredScan, n_stripes: int):
    """Partition one anchored scan into `n_stripes` MCU-row stripes.

    Returns a StripeSplit, or None when the scan isn't stripe-eligible
    (no structured plan, too few MCU rows, restart segments that would
    straddle a stripe, non-1x1-sampled non-interleaved scan)."""
    plan = staged.plan
    if (staged.frame is None or staged.scan is None
            or plan.structured is None or n_stripes < 2):
        return None
    (n_mcus, rows_d, cols_d, plen), specs = plan.structured
    if rows_d < n_stripes:
        return None
    f = staged.frame
    interleaved = len(staged.scan.component_indices) > 1
    if interleaved:
        if rows_d != f.mcu_size.height:
            return None          # clip-quirk geometry; keep single-device
    else:
        comp = f.components[staged.scan.component_indices[0]]
        if (len(f.components) != 1
                or comp.horizontal_sampling_factor != 1
                or comp.vertical_sampling_factor != 1):
            return None

    k = -(-rows_d // n_stripes)
    bpr = cols_d * plen                      # blocks per MCU row
    nb_local = k * bpr
    for (_s0, bpm, _vs, _hs, _Hc, _W, seg_blocks) in specs:
        if seg_blocks and (k * cols_d * bpm) % seg_blocks:
            return None          # a restart segment would straddle a stripe

    # Per-stripe sub-plan: the stripe is a sub-image of k whole MCU rows.
    sub = copy.deepcopy(f)
    v_max = (max(c.vertical_sampling_factor for c in f.components)
             if interleaved else 1)
    sub.image_size = Dimensions(f.image_size.width, k * 8 * v_max)
    sub.mcu_size = update_component_sizes(sub.image_size, sub.components)

    n = staged.n_items
    blk = staged.anchor_block[:n].astype(np.int64)
    ab = staged.anchor_bits[:n].astype(np.int64)
    ranges = _stripe_ranges(blk, n, nb_local, n_stripes, staged.n_blocks)

    # Uniform buckets across stripes.
    items_max = max((i1 - i0) for i0, i1 in ranges)
    if items_max == 0:
        return None
    I = _bucket_up(items_max)

    # Word windows: stripe d's bits end at the entry of chunk i1 (chunks
    # tile the bitstream; the truncated last chunk never reads past the
    # next anchor) or at the scan end for the final data stripe.
    w0s, w_his = [], []
    for d, (i0, i1) in enumerate(ranges):
        if i1 <= i0:
            w0s.append(0)
            w_his.append(0)
            continue
        bit_hi = int(ab[i1]) if i1 < n else staged.n_words * 32
        w0s.append(int(ab[i0]) >> 5)
        w_his.append(min(staged.n_words, (bit_hi >> 5) + 2))
    Wb = _bucket_up(max(h - l for l, h in zip(w0s, w_his)) + WORDS_PAD, 1024)

    words_s = np.zeros((n_stripes, Wb), np.uint32)
    abits_s = np.zeros((n_stripes, I), np.uint32)
    ablk_s = np.empty((n_stripes, I + 1), np.int32)
    aslot_s = np.zeros((n_stripes, I), np.int32)
    for d, (i0, i1) in enumerate(ranges):
        b0 = d * nb_local
        m = i1 - i0
        # Sentinel/pad: the true remaining block count, so the final data
        # stripe's last chunk stops at the real stream end instead of
        # decoding zero-padding bits across the crop region.
        fill = int(min(nb_local, max(staged.n_blocks - b0, 0)))
        ablk_s[d] = fill
        if m == 0:
            continue
        words_s[d, :w_his[d] - w0s[d]] = staged.words[w0s[d]:w_his[d]]
        abits_s[d, :m] = (ab[i0:i1] - (w0s[d] << 5)).astype(np.uint32)
        ablk_s[d, :m] = (blk[i0:i1] - b0).astype(np.int32)
        aslot_s[d, :m] = staged.anchor_slot[i0:i1]

    words_bucket = Wb
    sub_plan = _plan_for(sub, staged.scan, plan.restart_interval, I,
                         words_bucket, plan.s_max)
    st = sub_plan.structured
    if (st is None or st[0][0] != k * cols_d or st[0][3] != plen
            or sub_plan.n_blocks != nb_local):
        return None              # sub-geometry didn't reproduce the stream

    syms = staged.chunk_syms
    return StripeSplit(
        plan=sub_plan, n_stripes=n_stripes, mcu_rows=rows_d, k_mcu=k,
        n_blocks_local=nb_local, words=words_s, anchor_bits=abits_s,
        anchor_block=ablk_s, anchor_slot=aslot_s, luts=staged.luts,
        tabs=(None if staged.tab_maxcode is None else
              (staged.tab_maxcode, staged.tab_delta,
               staged.tab_values.view(np.int32))),
        comp_to_upair=staged.comp_to_upair,
        n_items=tuple(i1 - i0 for i0, i1 in ranges),
        n_words=tuple(h - l for l, h in zip(w0s, w_his)),
        s_max=tuple(int(syms[i0:i1].max()) if syms is not None and i1 > i0
                    else plan.s_max for i0, i1 in ranges))


def stripe_wire(split: StripeSplit, d: int) -> tuple:
    """Stripe d's 12 B/chunk anchor wire, int32 numpy arrays (words, dm,
    ab, base) for K1 (`entropy/chunk_decode.py::decode_chunks`), and its
    s_max: the stripe's words, `budget << 4 | slot` per real chunk (each
    budget the distance to the next chunk's first block, the last one's to
    the stripe's real block extent, `anchor_block[d, m]`: never more than
    the chunk's own budget, so the fields hold), entry bits and first
    blocks rebased to the stripe (the straddler's negative)."""
    m = split.n_items[d]
    ablk = split.anchor_block[d].astype(np.int64)
    dm = anchor_meta(ablk[1:m + 1] - ablk[:m],
                     split.anchor_slot[d, :m].astype(np.int64))
    words = np.ascontiguousarray(
        split.words[d, :max(split.n_words[d], 1)]).view(np.int32)
    return (words, dm, np.ascontiguousarray(split.anchor_bits[d, :m])
            .view(np.int32), ablk[:m].astype(np.int32)), \
        max(split.s_max[d], 1)


def padded_stripe_wire(split: StripeSplit, d: int) -> tuple:
    """Stripe d's anchor wire as a graph of the line takes it
    (`stripe_wire` padded to the split's buckets, as `graphs.wire_arrays`
    pads an image's): the words zero-padded to the split's `Wb`, and the
    chunks to its `I` with budget-0 chunks at entry bit 0 whose first
    block is the stripe's end (`n_blocks_local`): they decode nothing, and
    the first blocks stay nondecreasing, as K1 needs."""
    (_words, dm, ab, base), _s_max = stripe_wire(split, d)
    n_items = split.anchor_bits.shape[1]
    padded = [np.ascontiguousarray(split.words[d]).view(np.int32)]
    for a, fill in ((dm, 0), (ab, 0), (base, split.n_blocks_local)):
        p = np.full(n_items, fill, np.int32)
        p[:len(a)] = a
        padded.append(p)
    return tuple(padded)


def stripe_body(geometry, plan, kept: tuple, mcu_rows: int, n: int,
                wires: list, tables: list, s_maxes: list, qts_b: list,
                params: list, owners=None) -> list:
    """The device half of a line of stripes, on each stripe's device: per
    stripe K1 over each image's stripe wire into its rows of one nat, the
    DC totals (kernel D1); the exclusive carry of the earlier stripes;
    per stripe assembly with its carry; the halo'd reconstruction of every
    image of the line at once. `wires[j][b]` is image b's (words, dm, ab,
    base) on local stripe j's device, `tables[j][b]` its K1 tables there
    and `s_maxes[j][b]` K1's step bound on it, `qts_b` per image its
    tables and `params[j]` the lookups of stripe j's device; `plan` the
    stripes' plan, `kept` the scan's kept components. Returns per local
    stripe uint8 [b, R, W(, C)] on its device. With `owners` (the rank of
    each stripe, on a mesh across processes) the lists hold this
    process's stripes, and the carry and the halo cross from the
    others."""
    nats, totals = [], []
    for wire_j, tables_j, s_max_j in zip(wires, tables, s_maxes):
        nat = torch.empty((len(wire_j), plan.n_blocks, 64),
                          dtype=torch.int16, device=wire_j[0][0].device)
        for (words, dm, ab, base), tab, s_max, rows in zip(
                wire_j, tables_j, s_max_j, nat):
            with torch.profiler.record_function("k1_decode"):
                decode_chunks(words, dm, ab, base, tab, s_max, plan.n_blocks,
                              out=rows)
        nats.append(nat)
        totals.append(dc_totals(nat, plan))           # [b, ncomp] int64
    carries = exclusive_carry(totals, owners)
    stores = []
    for nat, carry in zip(nats, carries):
        with torch.profiler.record_function("assemble"):
            scan_stores = assemble_nat(nat, plan, None, carry.T)
        local = [None] * len(qts_b[0])
        for pos, comp_i in kept:
            local[comp_i] = scan_stores[pos]
        stores.append(local)
    recon = build_stripe_local_recon(geometry, mcu_rows, n)
    with torch.profiler.record_function("reconstruct"):
        return recon(stores, qts_b, params, owners)


def _decode_stripes(staged_list: list, splits: list, devs, mesh,
                    owners=None) -> list:
    """The images of one data shard (one plan), each striped over `devs`,
    dispatched eagerly: per stripe its real chunks' wire (`stripe_wire`)
    put to its device for each image, then `stripe_body`. Returns per
    stripe uint8 [b, R, W(, C)] on its device. With `owners` (the rank of
    each stripe, on a mesh across processes) only this process's stripes
    run, and the carry and the halo cross from the others."""
    s0, st0 = splits[0], staged_list[0]
    n = s0.n_stripes
    at = range(n) if owners is None else local_positions(owners)
    wires, tables, s_maxes = [], [], []
    for d in at:
        params = mesh.params(devs[d])
        arrays = [stripe_wire(sp, d) for sp in splits]
        wires.append([put(a, devs[d]) for a, _s in arrays])
        s_maxes.append([s for _a, s in arrays])
        tables.append([params.tables(st.scans[0].scan) for st in staged_list])
    return stripe_body(st0.geometry, s0.plan, st0.scans[0].kept, s0.mcu_rows,
                       n, wires, tables, s_maxes,
                       [st.qts for st in staged_list],
                       [mesh.params(devs[d]) for d in at], owners)


def _stripes_graph_body(_dec, shape, inputs) -> torch.Tensor:
    """A "stripes" graph's body (`graphs.BodyShape.fn`): `stripe_body` on
    the graph's inputs (every stripe on the graph's device, each image's
    padded wire and K1's step bound the plan's), the stripes' rows cropped
    to the image's and gathered: uint8 [b, H, W(, C)]."""
    n, b = shape.line.n_stripes, shape.images
    scan = shape.scans[0]
    wires = [inputs.wires[d * b:(d + 1) * b] for d in range(n)]
    outs = stripe_body(shape.geometry, scan.plan, scan.kept,
                       shape.line.mcu_rows, n, wires, [inputs.tables] * n,
                       [[scan.s_max] * b] * n, inputs.qts_b,
                       [inputs.params] * n)
    dev = outs[0].device
    return gather_rows([o for _, o in _crop_rows(
        outs, range(n), shape.geometry.out_height)], dev, dim=1)


def _stripes_fill(staged_list: list, splits: list, cache):
    """The images of one line landed in their `graphs.stripes_key`'s graph
    of `cache` (every stripe's padded wire, each image's K1 tables and
    exact tables) in one H2D submission (a `graphs.Fill`); None at the
    key's first sight on a card."""
    s0, st0 = splits[0], staged_list[0]
    key = graphs.stripes_key(staged_list, s0)
    if cache.first_sight(key):
        return None
    scan = st0.scans[0]
    shape = graphs.BodyShape(
        (graphs.ScanShape("anchor", s0.plan, scan.kept, s0.plan.s_max,
                          s0.n_blocks_local),),
        len(st0.qts), st0.geometry, len(staged_list), False, "stripes",
        line=graphs.StripeLine(s0.mcu_rows, s0.n_stripes),
        fn=_stripes_graph_body)
    wires = [padded_stripe_wire(sp, d) for d in range(s0.n_stripes)
             for sp in splits]
    return cache.fill(key, shape, wires, [st.scans[0].scan
                                          for st in staged_list],
                      [st.qts for st in staged_list])


def _striped_line(staged_list: list, splits: list, devs, mesh) -> torch.Tensor:
    """The images of one line (one data shard, one plan) striped over
    `devs` on a mesh of one process: uint8 [b, H, W(, C)] on the mesh's
    first device. A line whose devices and the mesh's first are one device
    (`graphs.one_device`) replays its `stripes` graph from its key's second
    call (the first dispatches eagerly, off any graph); any other line
    dispatches eagerly (`_decode_stripes`), the rows gathered on the
    mesh's first device."""
    n = splits[0].n_stripes
    if graphs.one_device(mesh, devs):
        fill = _stripes_fill(staged_list, splits,
                             graphs.device_graphs(devs[0]))
        if fill is not None:
            return fill.run()
    outs = _decode_stripes(staged_list, splits, devs, mesh)
    return gather_rows([o for _, o in _crop_rows(
        outs, range(n), staged_list[0].geometry.out_height)], mesh.first,
        dim=1)


def _crop_rows(outs: list, at, rows: int) -> list:
    """The stripes' outputs [b, R, ...] at positions `at` cut to the
    image's `rows` output rows: [(global rows, tensor)], the padding
    stripes' rows dropped."""
    cut = []
    for d, o in zip(at, outs):
        r0 = d * o.shape[1]
        take = max(0, min(o.shape[1], rows - r0))
        if take:
            cut.append((slice(r0, r0 + take), o[:, :take]))
    return cut


def _split_one(st, n: int):
    """The StripeSplit of a StagedBits whose one scan covers every
    component, or None."""
    if st is None or len(st.scans) != 1:
        return None
    if len(st.scans[0].kept) != len(st.qts):
        return None
    return split_anchored_stripes(st.scans[0].scan, n)


def check_engine(engine) -> None:
    """The reference's `engine` argument: None or "xla", the port's one
    engine (K1 on the anchor wire); anything else raises."""
    if engine not in (None, "xla"):
        raise ValueError(f"engine {engine!r}: the port has one engine (K1 "
                         "on the anchor wire); pass None or 'xla'")


def decode_bits_striped(staged_bits, mesh, stripe_axis: str = "stripe",
                        engine: str = None):
    """Decode ONE staged image with its MCU rows, entropy decode included,
    split over `mesh`'s stripe axis. Returns uint8 [H, W(, C)] on the
    mesh's first device (the stripes' rows gathered there, cropped to the
    output size), or None when the image isn't stripe-eligible (the caller
    falls back to the one-device pipeline). On a mesh across processes it
    returns this process's `Shard`s (index (rows,), cropped), each on its
    stripe's device.

    `staged_bits`: a `models.stream.StagedBits` with one scan covering
    every component. `engine`: `check_engine`."""
    check_engine(engine)
    n = int(mesh.shape[stripe_axis])
    split = _split_one(staged_bits, n)
    if split is None:
        return None
    rows = staged_bits.geometry.out_height
    devs = mesh.axis_devices(stripe_axis)
    if mesh.processes > 1:
        owners = mesh.axis_owners(stripe_axis)
        at = local_positions(owners)
        outs = _decode_stripes([staged_bits], [split], devs, mesh,
                               owners) if at else []
        return [Shard((r,), o[0]) for r, o in _crop_rows(outs, at, rows)]
    return _striped_line([staged_bits], [split], devs, mesh)[0]


def decode_bits_striped_batch(staged_list, mesh, data_axis: str = "data",
                              stripe_axis: str = "stripe"):
    """Decode a batch of SAME-LAYOUT staged images with batch DP over
    `data_axis` and per-image MCU-row stripes (entropy included) over
    `stripe_axis`: the DP x SP composition on the bits path. Returns uint8
    [B, H, W(, C)] on the mesh's first device, or None when an image
    declines (different plans or geometries, stripe-ineligible). The batch
    must be a multiple of the data-axis size. Plans compare by their key
    (equal plans built after a cache eviction are the same layout). Each
    image decodes with its own Huffman and quantization tables. On a mesh
    across processes it returns this process's `Shard`s (index (images,
    rows)); every process passes the whole batch."""
    n = int(mesh.shape[stripe_axis])
    nd = int(mesh.shape[data_axis])
    if not staged_list or len(staged_list) % nd:
        return None
    splits = [_split_one(st, n) for st in staged_list]
    if any(sp is None for sp in splits):
        return None
    if any(sp.plan != splits[0].plan for sp in splits[1:]):
        return None
    g0 = staged_list[0].geometry
    if any(st.geometry != g0 for st in staged_list[1:]):
        return None
    per = len(staged_list) // nd
    grid = mesh.axis_devices(data_axis, stripe_axis)
    lines = mesh.axis_owners(data_axis, stripe_axis)
    spread = mesh.processes > 1
    parts = []
    for k, (devs, line) in enumerate(zip(grid, lines)):
        at = local_positions(line) if spread else range(n)
        if not at:
            continue
        images = slice(k * per, (k + 1) * per)
        if not spread:
            parts.append(_striped_line(staged_list[images], splits[images],
                                       devs, mesh))
            continue
        outs = _decode_stripes(staged_list[images], splits[images], devs,
                               mesh, line)
        parts.extend(Shard((images, r), o)
                     for r, o in _crop_rows(outs, at, g0.out_height))
    return parts if spread else torch.cat(parts)

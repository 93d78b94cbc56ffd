"""Compiled dispatch: one CUDA graph per key, on the bits, prefix and
lossless paths, on the mesh and in `Decoder`.

Counterpart of the JAX package's compiled pipelines: `_compiled_bits_pipeline`
and `_compiled_bits_pipeline_batched` (`jpeg_decoder_tpu/models/stream.py:
919-1014`), `_compiled_prefix_pipeline` and
`_compiled_prefix_pipeline_batched` (`:73-165`) and
`_compiled_lossless_pipeline` (`:766-815`): `lru_cache`s of `jax.jit(run)`,
compiled on a key's first call and replayed, keyed only on what is static,
with the wire and the tables passed at run time. Here the device half of
one image (`DeviceStreamDecoder._run_device`) or of a group
(`_run_group`) is captured once per key as a `torch.cuda.CUDAGraph` and
replayed: no wrapper's Python (checks, ctypes argument arrays, K2's segment
table, status-buffer epochs) runs on a replay. One LRU of
GRAPH_CACHE_SIZE graphs holds every kind, since a bits decoder meets
prefix fallbacks and lossless images too.

On a mesh, and in `Decoder`, the counterparts of the JAX package's
`_compiled_bits_pipeline_batched_mesh` (`stream.py:1198-1233`),
`_compiled_stripe_bits_xla{,_batch}` (`parallel/stripe_bits.py:278-310`,
`:358-395`), `make_stripe_pipeline` (`parallel/stripes.py:135-182`),
`make_batch_pipeline` (`parallel/batch.py:23-50`) and `_compiled_pipeline`
(`ops/pipeline.py:134-144`):
- a data shard of `DeviceStreamDecoder(mesh=...)` lands in, and replays
  from, the decoder's cache of the shard's device: one cache per distinct
  device this process runs on, so the slots of one card share one LRU
  (a key replays once per shard, each shard landing its own arena in
  stream order) and its bound stays GRAPH_CACHE_SIZE graphs a card; the
  shard's keys are the one-device keys of its rows;
- a line of stripes (`parallel/stripe_bits.py`, `parallel/stripes.py`),
  a batched shard (`parallel/batch.py`) and `Decoder`'s reconstruction
  replay from the process's cache of their device (`device_graphs`, one a
  device, as the JAX package's module-level `lru_cache`s of its jit
  programs are one a process): the "stripes" kind (`stripes_key`: per
  stripe K1 over each image's padded stripe wire, D1, the exclusive
  carry, A1, E1, the halo rows, T1, the rows gathered), "stripe_recon"
  (`stripe_recon_key`: the same without the entropy half) and "recon"
  (`recon_key`: K2 or E1, then T1, on stores).
A line is captured only when its devices, and the one its rows gather
on, are one device in a mesh of one process (`one_device`): a line over
several cards, or any line of a mesh across processes, dispatches
eagerly, decided before any capture. Every exchange of a captured line is
a device-to-device copy inside the graph; the bytes it moves are counted
at capture and added at every replay, as the launches are (`_build.count`
into the graph's tally, `_build.add_tally`).

The kinds (`BodyShape.half`) and their keys:
- "whole", a bits image or a bits group of one (plan, geometry) (`bits_key`,
  below): every scan's K1, then assembly and the reconstruction;
- "sweep" and "part", a bits group of several (plan, geometry) parts
  (`sweep_key`, `part_key`, below);
- "prefix", a prefix image or group (`prefix_key`: the geometry, its
  precision beside it, the residuals' length, the layout and None or the
  count bucket): P1, then the reconstruction;
- "lossless", a SOF3 image or group (`lossless_key`: the component count,
  predictor, point transform, precision, `restart_all`, the output's width
  and height, the planes' [H, W] and None or the count bucket): the
  closed forms or L1, then the interleave;
- "recon", "stripes" and "stripe_recon" (above), which run without a
  decoder.
Every kind's shape holds its body (`BodyShape.fn`).
Two images share a key exactly when they share the JAX package's (the
"stripes" key also holds each image's n_tab, the rows of its K1 tables,
which the JAX package's LUTs do not show).

A group is padded to its count bucket (`batch_bucket`) on the prefix and
lossless paths, as the JAX package pads it: the rows past the group's
images take its last image's inputs, so that every slot of a graph
decodes this call's inputs and no replay reads what an earlier call left;
the pad images are decoded and never returned (`Fill.count`). A prefix
group's dropped residuals land at a sink past the bucket's stores. The
prefix path's K2 and E1 take a segment per (image, component) of the
bucket: at `decode_stream(batch_size=16)` at most 48, one launch.

A bits group of several (plan, geometry) parts (mixed sizes of one
encoder) runs in two halves, as the JAX package's
`_decode_group_bits_hetero` (`stream.py:1776-1853`) runs it: one sweep
graph (`sweep_key`, the counterpart of `_compiled_bits_sweep`,
`:1017-1033`: U1 and K1 over the merged wire, keyed on the wire's
bucketed shapes and a bucketed block count, never on the group's
composition) whose static output is `nat`, then per part one part graph
(`part_key`, the counterpart of `_compiled_nat_reconstruct`, `:1036-1070`:
A1 and the reconstruction of a count bucket of images of one plan). A
graph bakes its pointers in, so the part's offset into `nat` cannot be a
captured argument as JAX's `dynamic_slice` offset is a runtime scalar:
the part graph owns a static `nat_in` of `count_bucket x n_blocks` rows
that nothing else writes, and each call copies the part's rows into it
(one device-to-device copy on the stream, issued by `BitsGraphs.run`)
before the replay. Rows past the part's images keep what they held: the
pad slots decode them and are never returned, and every kernel of the
part body works image by image, so no returned image depends on them.

The bits key (`bits_key`) holds what the JAX compile key holds: the plans with
their kept components, the component count, the geometry (its precision
included), the layout, and per scan the wire kind, n_tab, `comp_to_upair`
and the wire's bucketed lengths, with the delta wire's class shapes
`(slot_words, s_max, n_bucket)` (the JAX key strips the content-dependent
n_items, and so does this one) or the anchor wire's plan's s_max (the
prescan's bucket); for a group, also the image count. The precision appears beside the geometry
for the reader. Images of one encoder at one size share a key whatever
their Huffman or quantisation tables, as they share an executable in JAX.

Runtime inputs (`Inputs`): each graph owns one uint8 device buffer, its
arena, that holds every input that changes from call to call at a fixed
offset: per scan the wire (the delta wire as `pack_delta` buckets it; the
anchor wire padded to `_bucket_up` of its words and chunks with budget-0
chunks, which decode nothing, their first block the scan's end) and K1's
tables; the zigzag map; per image and component the quantisation table,
float32 with the table folded into the IDCT basis for K2 (`params.
folded_basis`, the bits K2's wrapper would fold), or int32 for E1. One
call fills it with one H2D copy through the pinned pool
(`transfer.put_into`), the wire included, so the wire lands in the graph's
inputs within the submission that carried it before; every call lands the
whole arena, its tables included. A prefix graph's arena holds the prefix
wire (dc int16 [B, n], ac int8 [B, n, 15], the residuals' int32 indices
and int16 values [B, width]) and per image and component its table; a
lossless graph's its planes (int16 [B, C, H, W]). What a key fixes the graph holds
itself, so no cache eviction frees what it reads: the zero-padded IDCT
bases and a general plan's index maps, taken from the decoder's caches
(uploaded once a decoder: an upload from pageable memory waits for the
card), and its status buffers.
The tables' host arrays are cached by content, as `params.DeviceParams`
caches their device copies, so that K1's lookup tables and K2's folded
bases are not rebuilt on every call.
K2's and E1's segments take one table slot each per (image, component):
no two images' segments merge, as the eager path merges those that share
a table tensor, so a group takes N x C segments. A launch takes 64, so a
group of more than 21 three-component images takes two K2 (or E1)
launches where the eager path took one.

Dispatch (on a CUDA device): a key's first call dispatches eagerly, off
any graph (`BitsGraphs.first_sight`): it builds
the kernels and makes the per-card `cudaFuncSetAttribute` opt-ins, and
a key seen once costs what eager dispatch costs and makes no graph. At
its second call (if it recurs within the last GRAPH_CACHE_SIZE first
sights) the key gets its graph: the call lands its inputs in the graph's
arena, runs the body eagerly on them (the warm-up, whose output it
returns: it makes the status buffers, which no capture may allocate) and
captures it on a side stream (`BitsGraphs.run`); every later call lands
and replays. So a stream that cycles through more keys than the cache
holds runs eagerly, never capturing a graph that it would evict before
its reuse. A replay's output is copied out of
the graph's static buffer into a tensor of the caller's own (one
device-to-device copy, ~10 MB at large_420): a later replay never writes
into a tensor handed out earlier. A capture or replay that fails raises;
nothing falls back to eager dispatch. The capture neither synchronises
the host nor empties the allocator's caches (which `torch.cuda.graph`
does), so no other user of the device pays for it. On the CPU every
call runs the body eagerly on the graph's inputs, through the kernels'
plain versions.

Status buffers: A1 (and U1 on a wire of more than one tile) take their
epoch from the card (`_build.DeviceEpochs`), since a replay would repeat
a host epoch baked in at capture. Launch counts: a capture launches
nothing and counts nothing; each replay adds the graph's launches, by
kernel, to `_build.LAUNCHES`, and its exchanges' bytes to
`parallel.mesh.EXCHANGED` (`_build.add_tally`), so launches and bytes per
image stay what the eager body counts.

Span names (`torch.profiler.record_function`) run on the host at capture,
not at replay: a replay shows as one "bits_graph" span on the host, and
the card's kernels inside it carry their own names only.

A hetero group (`DeviceStreamDecoder._group_halves`) lands the sweep's
arena (the merged wire, K1's tables) and each part's (its images'
quantisation tables, the pad slots the last image's) in one H2D
submission each; each half whose key is at its first sight on a card
runs eagerly, on tensors put to the device, so a warm part graph runs
behind an eager sweep and the other way round. The sweep's static nat is
handed to the parts' copies only, all enqueued before the next replay of
any graph of the group; two parts of one group have two keys, so they
share no static buffer.

A graph's arena and static tensors are shared by its calls: a call whose
arena another call refilled before it ran fills it again, and each cache
holds its lock from that check through the replay and the copy out of
its output, so callers on several threads (two meshes, a mesh and a
`Decoder`, on one card's `device_graphs`) each get their own inputs'
output; the
card orders their work on the device's current stream, which every
caller of a cache shares. A hetero group's sweep hands its static nat on
after the run (above): its graphs live in the cache of the decoder that
dispatches them, from one thread.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np
import torch

from .. import _build
from ..host.entropy.prescan import _bucket_up
from ..host.staging import _bucket
from ..ops.pipeline import reconstruct
from ..params import (ScanTables, device_params, folded_basis,
                      scan_table_arrays)
from ..transfer import ALIGN, checked_device, put_into

# Graphs a decoder keeps, of every kind. JAX keeps 128 bits executables,
# 256 prefix and 32 lossless, which hold no activations; a captured graph
# holds its private memory pool (~46 MB at large_420, ~50 MB for a group
# of 16 tower_420), so the bound is tighter: 32 graphs of large_420 hold
# ~1.5 GB.
GRAPH_CACHE_SIZE = 32
_HOST_CACHE = 256       # host-side table arrays kept by content

# The arena's dtypes: the wires and tables (int32, float32), the prefix
# wire's dc and residual values and the lossless planes (int16; the planes
# are uint16 sent as int16 bit patterns) and its AC slots (int8).
_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.int8): torch.int8}


def batch_bucket(n: int) -> int:
    """The JAX package's group bucket (`stream.py:206`, `_batch_bucket`):
    the least power of two >= n. The images of a prefix or lossless
    group's graph and of a hetero part's, the sweep's block count, and on
    a mesh the shards' rows."""
    size = 1
    while size < n:
        size *= 2
    return size


@dataclasses.dataclass(frozen=True)
class ScanShape:
    """What the body needs of one scan, fixed by the key."""
    wire: str            # "delta" or "anchor"
    plan: object         # the scan's ScanPlan (None in a sweep)
    kept: tuple          # ((scan component position, frame component), ...)
    s_max: int           # K1's step bound
    n_blocks: int        # rows of nat: every image's blocks of the scan


@dataclasses.dataclass(frozen=True)
class LosslessShape:
    """What a lossless body reads of its images beside their planes: the
    fields of `StagedLossless` that `stream.lossless_images` takes (a
    graph keeps these, not an image whose planes it would hold alive)."""
    predictor: int
    point_transform: int
    precision: int
    restart_all: bool
    out_width: int
    out_height: int


@dataclasses.dataclass(frozen=True)
class StripeLine:
    """What a stripe body reads beside its inputs: the image's decoded MCU
    rows and the stripes they split into."""
    mcu_rows: int
    n_stripes: int


@dataclasses.dataclass(frozen=True)
class BodyShape:
    """The static structure of a graph's body. `half`: "whole" (every
    scan's K1, then the reconstruction), "sweep" (K1 over a merged wire
    only: its nat out), "part" (the reconstruction of `nat_in`), "prefix"
    (P1 over the prefix wire, then the reconstruction), "lossless" (the
    predictors and the interleave; `geometry` a `LosslessShape`), "recon"
    (the reconstruction of stores), "stripes" (a line of stripes, entropy
    included; `line` its `StripeLine`) or "stripe_recon" (a line of
    stripes' reconstruction of stores). `fn`, the body: fn(dec, shape,
    inputs) -> tensor, `dec` the decoder whose body it is (None for the
    last three kinds, which run without one)."""
    scans: tuple         # (ScanShape, ...)
    ncomp: int
    geometry: object
    images: int
    fp32: bool           # K2 on folded float32 tables, else E1 on int32
    half: str = "whole"
    line: StripeLine = None
    fn: object = None


@dataclasses.dataclass
class QtSlot:
    """One (image, component)'s quantisation table in the arena: float32
    `q` and its basis `folded` for K2, or int32 `q_exact` for E1."""
    q: torch.Tensor = None
    folded: torch.Tensor = None
    q_exact: torch.Tensor = None


class SlotParams:
    """`params.DeviceParams`' lookups (`qt`, `folded`, `qt_exact`,
    `basis`) answered from a graph's inputs: the tables of `QtSlot`s, the
    bases the graph holds."""

    def __init__(self, bases: dict):
        self._bases = bases

    def qt(self, slot: QtSlot) -> torch.Tensor:
        return slot.q

    def folded(self, slot: QtSlot, scale: int) -> torch.Tensor:
        return slot.folded

    def qt_exact(self, slot: QtSlot) -> torch.Tensor:
        return slot.q_exact

    def basis(self, scale: int) -> torch.Tensor:
        return self._bases[scale]


@dataclasses.dataclass
class Inputs:
    """A graph's inputs, as the body reads them: per scan its wire (words,
    dm[, ab, base]; the prefix wire (dc, ac, resid_idx, resid_vals); the
    lossless planes (diffs,); a "recon" body's stores, one per component;
    a "stripe_recon" body's per stripe; a "stripes" body's per stripe and
    image, stripe after stripe), K1's tables (a "stripes" body's per
    image) and, for a plan without the closed form, its index maps; per
    image its components' `QtSlot`s; `params` the lookups of the
    reconstruction; a part's `nat`, its rows of the sweep's nat."""
    wires: list
    tables: list
    maps: list
    qts_b: list
    params: SlotParams
    nat: torch.Tensor = None


def _scan_key(st, lengths: tuple, s_max: int, shapes) -> tuple:
    scan = st.scan
    head = (st.wire, len(scan.tab_maxcode), tuple(scan.comp_to_upair),
            lengths)
    if st.wire == "delta":
        return head + (tuple(tuple(s[:3]) for s in shapes),)
    return head + (s_max,)


def wire_arrays(wire: str, arrays: tuple, n_blocks: int) -> tuple:
    """A scan's (or a group's merged) wire arrays as a graph takes them:
    the delta wire as `pack_delta` (or its merge) buckets it; the anchor
    wire's words zero-padded to `_bucket_up(words, 1024)` and its chunks to
    `_bucket_up(chunks)` with budget-0 chunks at entry bit 0 whose first
    block is `n_blocks` (nondecreasing first blocks, as K1 needs; they
    decode nothing)."""
    if wire == "delta":
        return tuple(arrays)
    words, dm, ab, base = arrays
    nw, n = _bucket_up(len(words), 1024), _bucket_up(len(dm))
    pw = np.zeros(nw, np.int32)
    pw[:len(words)] = words
    out = [pw]
    for a, fill in ((dm, 0), (ab, 0), (base, n_blocks)):
        p = np.full(n, fill, np.int32)
        p[:len(a)] = a
        out.append(p)
    return tuple(out)


def bits_key(staged_or_group, precision: str, layout: str,
             merged=None) -> tuple:
    """The compile key of one StagedBits, or of a group of them (a list)
    whose merged wire is `merged`, (arrays, s_max, n_blocks, shapes) as
    `DeviceStreamDecoder` merges it (`_merge`). `layout` is the layout the
    decoder takes for the geometry (`_effective_layout`)."""
    if isinstance(staged_or_group, (list, tuple)):
        first = staged_or_group[0]
        arrays, s_max, n_blocks, shapes = merged
        st = first.scans[0]
        lengths = tuple(len(a) for a in
                        wire_arrays(st.wire, arrays, n_blocks)[:2])
        scans = (_scan_key(st, lengths, _s_max(st, s_max), shapes),)
        head = ("group", len(staged_or_group))
    else:
        first = staged_or_group
        scans = tuple(_scan_key(
            s, tuple(len(a) for a in wire_arrays(
                s.wire, _scan_arrays(s), s.scan.plan.n_blocks)[:2]),
            _s_max(s, s.s_max), s.shapes) for s in first.scans)
        head = ("image", 1)
    return head + (tuple((s.scan.plan, s.kept) for s in first.scans),
                   len(first.qts), first.geometry, layout, precision, scans)


def sweep_key(st, wire: tuple, s_max: int, shapes, n_blocks: int) -> tuple:
    """The compile key of a hetero group's sweep (`_compiled_bits_sweep`'s
    arguments and the shapes `jax.jit` traces): the wire kind, n_tab, the
    MCU pattern mapped through `comp_to_upair`, the graph's wire lengths
    (`wire`, `wire_arrays` of the merged wire), the delta wire's class
    shapes `(slot_words, s_max, n_bucket)` or the anchor wire's step bound
    `s_max`, and `n_blocks`, the block count bucketed as the JAX package
    buckets it (`DeviceStreamDecoder._group_halves`). `st` is the first
    image's StagedScan; no plan is in the key."""
    scan = st.scan
    pattern = tuple(scan.comp_to_upair[c] for c in scan.plan.pattern)
    tail = tuple(tuple(s[:3]) for s in shapes) if st.wire == "delta" \
        else s_max
    return ("sweep", st.wire, len(scan.tab_maxcode), pattern,
            tuple(len(a) for a in wire[:2]), tail, n_blocks)


def part_key(staged, count_bucket: int, precision: str, layout: str
             ) -> tuple:
    """The compile key of a hetero group's part: the JAX package's
    `_compiled_nat_reconstruct` key `(plan, count_bucket, geometry,
    layout)`, with the kept components, the component count and the
    precision beside them; `staged` is any image of the part."""
    s = staged.scans[0]
    return ("part", s.scan.plan, s.kept, len(staged.qts), count_bucket,
            staged.geometry, layout, precision)


def prefix_key(staged_or_group, precision: str, layout: str) -> tuple:
    """The compile key of one StagedImage (the prefix interchange), as
    `_compiled_prefix_pipeline` keys it: its geometry, the length of its
    residual lists (`stage_host` buckets it) and the layout; of a group (a
    list of one geometry), as `_compiled_prefix_pipeline_batched` does:
    `_bucket` of its longest residual list and its count bucket
    (`batch_bucket`). The precision appears beside the geometry, as in
    `bits_key`."""
    if isinstance(staged_or_group, (list, tuple)):
        first = staged_or_group[0]
        width = _bucket(max(len(st.resid_idx) for st in staged_or_group))
        images = batch_bucket(len(staged_or_group))
    else:
        first, images = staged_or_group, None
        width = len(first.resid_idx)
    return ("prefix", first.geometry, width, layout, precision, images)


def lossless_key(staged_or_group) -> tuple:
    """The compile key of one StagedLossless, or of a group of them (a
    list of one `group_key`), as `_compiled_lossless_pipeline` keys it:
    the component count, predictor, point transform, precision,
    `restart_all`, the output's width and height and None or the count
    bucket, with the planes' [H, W] that `jax.jit` traces."""
    group = isinstance(staged_or_group, (list, tuple))
    st = staged_or_group[0] if group else staged_or_group
    ncomp, h, w = st.diffs.shape
    return ("lossless", ncomp, st.predictor, st.point_transform,
            st.precision, st.restart_all, st.out_width, st.out_height,
            (h, w), batch_bucket(len(staged_or_group)) if group else None)


def recon_key(geometry, images: int) -> tuple:
    """The compile key of a reconstruction of stores (`ops/pipeline.py::
    reconstruct`), as the JAX package's `_compiled_pipeline` keys it on
    the geometry, and `make_batch_pipeline`'s program on the batch it
    traces: the geometry with its precision beside it, the image count and
    the layout (interleaved, the one both callers take)."""
    return ("recon", geometry, geometry.precision, images, "interleaved")


def stripes_key(staged_list: list, split) -> tuple:
    """The compile key of a line of stripes, entropy included
    (`parallel/stripe_bits.py`): the JAX package's
    `_compiled_stripe_bits_xla{,_batch}` key (the stripe plan, the kept
    components, the component count, the geometry, the MCU rows, the
    stripe count and the images of the line) with what `jax.jit` traces of
    the split's arrays: the words and chunks each stripe's wire is padded
    to, K1's step bound (the plan's s_max) and per image n_tab, the rows of
    its K1 tables. `staged_list` are the line's images (StagedBits of one
    plan), `split` the first one's `StripeSplit`; nothing of the content
    (the stripes' real chunk counts, words and symbol bounds) is in the
    key."""
    first = staged_list[0]
    st = first.scans[0]
    return ("stripes", split.plan, st.kept, len(first.qts), first.geometry,
            split.mcu_rows, split.n_stripes, len(staged_list),
            split.words.shape[1], split.anchor_bits.shape[1],
            split.plan.s_max,
            tuple(len(s.scans[0].scan.tab_maxcode) for s in staged_list))


def stripe_recon_key(geometry, mcu_rows: int, n_stripes: int, images: int
                     ) -> tuple:
    """The compile key of a line of stripes' reconstruction of stores
    (`parallel/stripes.py::make_stripe_pipeline`): the geometry, the MCU
    rows, the stripe count and the images of the line."""
    return ("stripe_recon", geometry, mcu_rows, n_stripes, images)


def one_device(mesh, devices) -> bool:
    """Whether a line of `mesh` (its entries' `devices`) runs as one
    graph: its devices and the mesh's first (where its rows gather) one
    `torch.device`, in a mesh of one process. A line over several cards
    dispatches eagerly, and so does every line of a mesh across processes
    (a crossing waits on the host): decided here, before any capture."""
    return mesh.processes == 1 \
        and len({torch.device(d) for d in devices} | {mesh.first}) == 1


def _s_max(st, s_max: int) -> int:
    """K1's step bound on a scan's wire (`s_max` its wire's own): on the
    anchor wire the plan's, the prescan's bucket of its chunks' symbol
    counts (`_s_max_bucket`), as the JAX key holds it; on the delta wire
    `s_max`, the bucket `pack_delta` chose."""
    return s_max if st.wire == "delta" else st.scan.plan.s_max


def _scan_arrays(st) -> tuple:
    """One image's scan wire, as `StagedScan` holds it."""
    if st.wire == "delta":
        return st.words, st.dm
    return st.words, st.dm, st.ab, st.base


def _whole_body(dec, shape: BodyShape, inputs: Inputs) -> torch.Tensor:
    return dec._bits_body(shape, inputs)


def _sweep_body(dec, shape: BodyShape, inputs: Inputs) -> torch.Tensor:
    return dec._sweep_body(shape, inputs)[0]


def _part_body(dec, shape: BodyShape, inputs: Inputs) -> torch.Tensor:
    return dec._part_body(shape, [inputs.nat], inputs)


def _prefix_body(dec, shape: BodyShape, inputs: Inputs) -> torch.Tensor:
    return dec._prefix_body(shape, inputs)


def _lossless_body(dec, shape: BodyShape, inputs: Inputs) -> torch.Tensor:
    return dec._lossless_body(shape, inputs)


def image_shape(staged, fp32: bool, keyed: bool = True) -> BodyShape:
    """The body's structure for one StagedBits: its key's, or (not
    `keyed`) on the image's own wires, as eager dispatch off a graph
    sends them, with each scan's own s_max."""
    return BodyShape(tuple(ScanShape(
        s.wire, s.scan.plan, s.kept,
        _s_max(s, s.s_max) if keyed else s.s_max,
        s.scan.plan.n_blocks) for s in staged.scans),
        len(staged.qts), staged.geometry, 1, fp32, fn=_whole_body)


def group_shape(group: list, merged, fp32: bool) -> BodyShape:
    """The body's structure for a same-plan group on its merged wire."""
    _arrays, s_max, n_blocks, _shapes = merged
    st = group[0].scans[0]
    return BodyShape((ScanShape(st.wire, st.scan.plan, st.kept,
                                _s_max(st, s_max), n_blocks),),
                     len(group[0].qts), group[0].geometry, len(group), fp32,
                     fn=_whole_body)


def sweep_shape(st, s_max: int, n_blocks: int) -> BodyShape:
    """A sweep's structure: K1 over a merged wire of `n_blocks` rows (the
    bucket on a graph, the images' blocks eagerly), no plan."""
    return BodyShape((ScanShape(st.wire, None, (), s_max, n_blocks),), 0,
                     None, 0, False, "sweep", fn=_sweep_body)


def part_shape(staged, images: int, fp32: bool) -> BodyShape:
    """A part's structure: the reconstruction of `images` images of the
    plan of `staged` (any image of the part) from their nat rows."""
    s = staged.scans[0]
    return BodyShape((ScanShape(s.wire, s.scan.plan, s.kept, 0,
                                images * s.scan.plan.n_blocks),),
                     len(staged.qts), staged.geometry, images, fp32, "part",
                     fn=_part_body)


def prefix_shape(staged, images: int, fp32: bool) -> BodyShape:
    """A prefix body's structure: P1 and the reconstruction of `images`
    images of the geometry of `staged` (any of them)."""
    return BodyShape((), len(staged.qts), staged.geometry, images, fp32,
                     "prefix", fn=_prefix_body)


def lossless_shape(staged, images: int) -> BodyShape:
    """A lossless body's structure: the planes of `images` images of the
    `group_key` of `staged` (any of them)."""
    return BodyShape((), 0, LosslessShape(
        staged.predictor, staged.point_transform, staged.precision,
        staged.restart_all, staged.out_width, staged.out_height), images,
        False, "lossless", fn=_lossless_body)


def recon_shape(geometry, images: int) -> BodyShape:
    """A "recon" body's structure: `reconstruct` of `images` images'
    stores of `geometry`, K2 at precision "fast", else E1, interleaved."""
    return BodyShape((), len(geometry.components), geometry, images,
                     geometry.precision == "fast", "recon", fn=_recon_body)


def _recon_body(_dec, shape: BodyShape, inputs: Inputs) -> torch.Tensor:
    with torch.profiler.record_function("reconstruct"):
        return reconstruct(shape.geometry, list(inputs.wires[0]),
                           inputs.qts_b, inputs.params)


def recon_fill(graphs: "BitsGraphs", geometry, stores: tuple, qts_b: list):
    """One reconstruction's stores (int16 [N, n_i, 64] numpy arrays, one
    per component) and per image its tables, landed in its `recon_key`'s
    graph of `graphs` in one H2D submission (a `Fill`); None at the key's
    first sight on a card."""
    key = recon_key(geometry, len(qts_b))
    if graphs.first_sight(key):
        return None
    return graphs.fill(key, recon_shape(geometry, len(qts_b)),
                       [tuple(np.ascontiguousarray(s, np.int16)
                              for s in stores)], [], qts_b)


@dataclasses.dataclass
class Fill:
    """One call's inputs landed in a graph's arena: `id` is the arena's
    fill count when they landed; `items` the (offset, array) pairs, kept
    to land them again if another call refilled the arena first; `count`
    the images the call returns, the first of the graph's (None: all);
    `owner` the `BitsGraphs` that holds the graph (`run`)."""
    graph: "BitsGraph"
    id: int
    items: list
    count: int = None
    owner: "BitsGraphs" = None

    def run(self, dec=None, eager: bool = False,
            rows: torch.Tensor = None) -> torch.Tensor:
        """`BitsGraphs.run` of this fill on its owner."""
        return self.owner.run(dec, self, eager, rows)


class BitsGraph:
    """One key's graph: its arena and the input views into it, what the
    body reads beside them (a part's `nat_in`), its device-epoch status
    buffers, and once captured the graph, its static output and what its
    capture counted (`tally`: its launches by kernel, the bytes its
    exchanges move by kind; `_build.count`)."""

    def __init__(self, key, shape: BodyShape, arrays: list, device,
                 maps: list, bases: dict):
        self.key, self.shape, self.device = key, shape, device
        self.nat_in = torch.zeros((shape.scans[0].n_blocks, 64),
                                  dtype=torch.int16, device=device) \
            if shape.half == "part" else None
        self.layout, off = [], 0
        for a in arrays:
            self.layout.append((off, a.dtype, a.shape))
            off += -(-max(a.nbytes, 1) // ALIGN) * ALIGN
        self.arena = torch.zeros(max(off, 1), dtype=torch.uint8,
                                 device=device)
        views = [self.arena[o:o + int(np.prod(sh)) * dt.itemsize]
                 .view(_TORCH_DTYPES[dt]).view(sh)
                 for o, dt, sh in self.layout]
        self.inputs = self._inputs(views, maps, bases)
        self.scope = _build.GraphScope(_build.DeviceEpochs(device))
        self.fill_id = 0
        self.graph = None
        self.out = None
        self.tally: dict = {}

    def _inputs(self, views: list, maps: list, bases: dict) -> Inputs:
        """The views in the order `BitsGraphs._arrays` lays the arrays,
        with per scan its index maps (or None) and the bases by scale."""
        sh = self.shape
        it = iter(views)
        wires, tables = [], []
        if sh.half in ("prefix", "lossless"):
            wires = [tuple(next(it) for _ in range(
                4 if sh.half == "prefix" else 1))]
        elif sh.half in ("recon", "stripe_recon"):
            wires = [tuple(next(it) for _ in range(sh.ncomp)) for _ in range(
                1 if sh.half == "recon" else sh.line.n_stripes)]
        elif sh.half == "stripes":
            wires = [tuple(next(it) for _ in range(4))
                     for _ in range(sh.line.n_stripes * sh.images)]
            tables = [[next(it) for _ in range(6)] for _ in range(sh.images)]
            unzig = next(it)
            tables = [ScanTables(*t, unzig=unzig) for t in tables]
        elif sh.half != "part":
            wires = [tuple(next(it) for _ in range(
                2 if scan.wire == "delta" else 4)) for scan in sh.scans]
            tables = [[next(it) for _ in range(6)] for _scan in sh.scans]
            unzig = next(it)
            tables = [ScanTables(*t, unzig=unzig) for t in tables]
        qts_b = []
        for _i in range(sh.images):
            if sh.fp32:
                qts_b.append([QtSlot(q=next(it), folded=next(it))
                              for _c in range(sh.ncomp)])
            else:
                qts_b.append([QtSlot(q_exact=next(it))
                              for _c in range(sh.ncomp)])
        return Inputs(wires, tables, maps, qts_b, SlotParams(bases),
                      self.nat_in)

    def body(self, dec) -> torch.Tensor:
        """The graph's body (`BodyShape.fn`) on its inputs: `dec` the
        decoder whose body it is (None for the kinds without one)."""
        return self.shape.fn(dec, self.shape, self.inputs)

    def items(self, arrays: list) -> list:
        """(offset, array) pairs of one call's arrays, checked against the
        layout the key fixed."""
        if len(arrays) != len(self.layout) or any(
                a.dtype != dt or a.shape != sh
                for a, (_o, dt, sh) in zip(arrays, self.layout)):
            raise ValueError("a call's inputs do not have its key's shapes")
        return [(o, a) for a, (o, _dt, _sh) in zip(arrays, self.layout)]


class BitsGraphs:
    """The graphs of one device, least recently used evicted past
    `maxsize`: a decoder's (one a device it runs on), or the process's
    (`device_graphs`); `captures`, `hits` (replays) and the host-side
    caches of the tables' arrays by content. `params` (the device's
    `params.DeviceParams`) and `maps` (plan, device -> `GeneralMaps`, or
    None where every plan has the closed form) are the owner's caches of
    what a key fixes: uploaded once, not once a graph, since an upload
    from pageable memory waits for the card. Its calls may come from
    several threads: each holds the cache's lock (`fill`, `run`)."""

    def __init__(self, device, params, maps):
        self.device = torch.device(device)
        self._params, self._maps = params, maps
        self.maxsize = GRAPH_CACHE_SIZE
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._tables: dict = {}
        self._qts: dict = {}
        self._stream = None     # the side stream captures run on
        self._seen: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.RLock()
        self.captures = 0
        self.hits = 0

    def clear(self) -> None:
        with self._lock:
            self._graphs.clear()
            self._seen.clear()
            self._tables.clear()
            self._qts.clear()

    def __len__(self) -> int:
        return len(self._graphs)

    def stats(self) -> dict:
        with self._lock:
            return {"graphs": len(self._graphs), "captures": self.captures,
                    "hits": self.hits}

    def _cached(self, cache: dict, key, make):
        val = cache.get(key)
        if val is None:
            if len(cache) > _HOST_CACHE:
                cache.clear()
            val = cache[key] = make()
        return val

    def _table_arrays(self, scan) -> ScanTables:
        key = (scan.tab_maxcode.tobytes(), scan.tab_delta.tobytes(),
               scan.tab_values.tobytes(), tuple(scan.comp_to_upair),
               tuple(scan.plan.pattern))
        return self._cached(self._tables, key,
                            lambda: scan_table_arrays(scan))

    def _qt_arrays(self, qt, scale: int, fp32: bool) -> tuple:
        q = np.asarray(qt)
        if not fp32:
            return self._cached(self._qts, (q.tobytes(), 0), lambda: (
                np.ascontiguousarray(q.astype(np.int32).reshape(64)),))
        return self._cached(self._qts, (q.tobytes(), scale), lambda: (
            np.ascontiguousarray(q.astype(np.float32).reshape(64)),
            folded_basis(q, scale, "cpu").numpy()))

    def _arrays(self, shape: BodyShape, wires: list, scans: list,
                qts_b: list) -> list:
        """Every input of one call, in the arena's order: every scan's wire
        arrays (the prefix or lossless wire's), every scan's K1 tables
        (six), the zigzag map, then per image and component its table(s).
        The tables' arrays come from the host-side caches, one object per
        content."""
        out = [a for wire in wires for a in wire]
        tabs = None
        for scan in scans:
            tabs = self._table_arrays(scan)
            out += [tabs.maxcode, tabs.delta, tabs.values, tabs.lut,
                    tabs.walk, tabs.pattern]
        if tabs is not None:
            out.append(tabs.unzig)
        scales = [c.dct_scale for c in shape.geometry.components] \
            if qts_b else []
        for qts in qts_b:
            for qt, s in zip(qts, scales):
                out += self._qt_arrays(qt, s, shape.fp32)
        return out

    def fill(self, key, shape: BodyShape, wires: list, scans: list,
             qts_b: list, count: int = None) -> Fill:
        """Land one call's inputs in its key's graph (made on first sight):
        `wires` per scan its arrays (`wire_arrays`; a prefix or lossless
        body's one wire), `scans` the `AnchoredScan`s whose tables K1 reads,
        `qts_b` per image its components' uint16[64] tables (a sweep and a
        lossless body have no `qts_b`, a part no `wires`, a part, a prefix
        and a lossless body no `scans`); `count` the images the call
        returns (`Fill.count`)."""
        with self._lock:
            return self._fill(key, shape, wires, scans, qts_b, count)

    def _fill(self, key, shape: BodyShape, wires: list, scans: list,
              qts_b: list, count: int) -> Fill:
        arrays = self._arrays(shape, wires, scans, qts_b)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = BitsGraph(
                key, shape, arrays, self.device,
                [None if scan.plan is None or scan.plan.structured is not None
                 else self._maps(scan.plan, self.device)
                 for scan in shape.scans],
                {} if shape.half in ("sweep", "lossless") else
                {c.dct_scale: self._params.basis(c.dct_scale)
                 for c in shape.geometry.components})
            while len(self._graphs) > self.maxsize:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(key)
        fill = Fill(graph, 0, graph.items(arrays), count, self)
        self._land(fill)
        return fill

    def _land(self, fill: Fill) -> None:
        """Land `fill`'s items in its graph's arena."""
        graph = fill.graph
        put_into(graph.arena, fill.items)
        graph.fill_id += 1
        fill.id = graph.fill_id

    def first_sight(self, key) -> bool:
        """Whether a call of `key` runs eagerly off any graph: on a card,
        where the key has no graph and was not seen among the last
        `maxsize` keys so seen (it is remembered now). So a key's first
        call on a card dispatches as eager dispatch does and makes no
        graph, and a stream that cycles through more keys than the cache
        holds never captures a graph it would evict before its reuse."""
        if self.device.type != "cuda":
            return False
        with self._lock:
            if key in self._graphs or self._seen.pop(key, False):
                return False
            self._seen[key] = True
            while len(self._seen) > self.maxsize:
                self._seen.popitem(last=False)
            return True

    def run(self, dec, fill: Fill, eager: bool = False,
            rows: torch.Tensor = None) -> torch.Tensor:
        """The body's output for the inputs of `fill`: eagerly on the CPU
        or with `eager`; on a card at the graph's first call by its warm-up
        and capture, then by replay. A whole, prefix or lossless body or a
        part gives [N, ...] (its first `fill.count` images), copied out of
        a replayed graph; a part first copies `rows` (its images' rows of
        the sweep's nat, int16 [count x n_blocks, 64]) into its `nat_in`
        and gives its first `count` images. A sweep gives its nat, the
        graph's static output itself: it is read by the parts' copies that
        follow on the stream, before the next replay, and never handed
        out. Holds the cache's lock from the check of the arena's fill
        through the copy out."""
        with self._lock:
            return self._run(dec, fill, eager, rows)

    def _run(self, dec, fill: Fill, eager: bool, rows: torch.Tensor
             ) -> torch.Tensor:
        graph = fill.graph
        if graph.fill_id != fill.id:
            self._land(fill)
        count = fill.count
        if rows is not None:
            graph.nat_in[:rows.shape[0]].copy_(rows)
            count = rows.shape[0] // graph.shape.scans[0].plan.n_blocks
        if eager or graph.device.type != "cuda":
            with _build.graph_scope(graph.scope):
                return graph.body(dec)[:count]
        if graph.graph is None:
            return self._capture(dec, graph)[:count]
        with torch.profiler.record_function("bits_graph"):
            graph.graph.replay()
        _build.add_tally(graph.tally)
        self.hits += 1
        if graph.shape.half == "sweep":
            return graph.out
        return graph.out[:count].clone()

    def _capture(self, dec, graph: BitsGraph) -> torch.Tensor:
        """The warm-up, whose output is returned: the body run eagerly on
        the graph's inputs, which makes its status buffers (the key's
        first call, off any graph, has built the kernels and made the
        per-card opt-ins). Then the capture, on the side stream: it
        launches and moves nothing, and what it would count (its launches
        by kernel, the bytes its exchanges move) goes to the graph's tally
        (`_build.count`), which every replay adds."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        scope = graph.scope
        with _build.graph_scope(scope):
            out = graph.body(dec)
        cuda_graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(graph.device), \
                    torch.cuda.stream(self._stream), \
                    _build.graph_scope(scope):
                scope.capturing, scope.tally = True, {}
                cuda_graph.capture_begin(capture_error_mode="thread_local")
                try:
                    static = graph.body(dec)
                finally:
                    scope.capturing = False
                    cuda_graph.capture_end()
        except BaseException:
            if self._graphs.get(graph.key) is graph:
                del self._graphs[graph.key]
            raise
        graph.graph, graph.out = cuda_graph, static
        graph.tally = scope.tally
        self.captures += 1
        return out


_registry: dict = {}
_registry_lock = threading.Lock()


def device_graphs(device) -> BitsGraphs:
    """The process's graph cache of one device, for the programs that run
    without a decoder: a line of stripes and the striped reconstruction
    (`parallel/stripe_bits.py`, `parallel/stripes.py`), a batched shard's
    reconstruction (`parallel/batch.py`) and `Decoder`'s
    (`decoder.reconstruct_tensor`). One a device ("cuda" is "cuda:N",
    `transfer.checked_device`), so the meshes and `Decoder`s of a process
    hold at most GRAPH_CACHE_SIZE such graphs a card together, as the JAX
    package's module-level `lru_cache`s of these programs are one a
    process. Their plans have the closed form: no general plan's index
    maps are asked of it."""
    device = checked_device(device)
    with _registry_lock:
        cache = _registry.get(device)
        if cache is None:
            cache = _registry[device] = BitsGraphs(
                device, device_params(device), None)
        return cache

"""Decode-to-device streaming on PyTorch: the stream decoder.

Port of `jpeg_decoder_tpu/models/stream.py`'s `DeviceStreamDecoder` on one
device, one image at a time or in batches, in both interchanges, both
precisions and the three layouts. Images come back as tensors on the decoder's device; the host
never reads pixels back:
- "interleaved": [H, W, C] (or [H, W] for grayscale), from kernel T1;
- "planar": [C, H, W], the interleaved result permuted (2-D outputs as
  they are), which T1 writes directly;
- "planar-pallas": [C, H, W] through kernel K3 (fused upsample + color)
  for the geometries `pallas_tail_mode` covers, else "planar" (one rule,
  `_effective_layout`, as in the reference).
Lossless (SOF3) images come back as [H, W] or [H, W, C], uint8 at
precision 8 and uint16 above it; layouts do not apply to them.

Host stage (per image, in a thread pool): the port's own copy of the JAX
package's numpy/C++ host code, `jpeg_decoder_tpu_torch.host`.
`stage_host_bits` routes a stream as the reference's `stage_host_bits`
does, branch for branch:
- baseline scans: the `BitstreamCapture` prescan, then per scan the
  4 B/chunk delta wire (`pack_delta`), or the 12 B/chunk anchor wire for
  scans it declines (more than 4 table rows, field overflow, long
  chunks);
- lossless frames: the `_LosslessCapture` difference planes
  (`StagedLossless`, the reference's typed `FormatError`s unchanged);
- `PrescanFallback` (quirk streams): a host decode, then `transcode`;
- progressive frames: `transcode` of the host-decoded stores;
- whatever `transcode` declines: the prefix interchange (`stage_host`).
The reference's `stage_host_bits` ends in `_attach_pallas` (the Pallas
class packing), which the port has no use for, so the copy leaves it out
and this function routes. The routing is the reference's host decision,
made from the stream; it catches no device or kernel error.
`interchange="prefix"` stages everything through `stage_host`, as the
reference does.

H2D (on the caller's thread, `h2d_submit`): the arrays of an image's or a
group's wire go to the device together through `transfer.put`, the
counterpart of the reference's asynchronous `device_put`: on a CUDA
device a copy into one page-locked buffer of the device's bounded pool,
then one non-blocking copy on the current stream; `_put_recorded` folds
submissions of 4 MB or more into `utils.link`'s rate estimate, as the
reference's does, and adds no synchronisation.

Device stage (per image or per group, on the caller's thread,
`device_dispatch`, asynchronous on the current CUDA stream; an image, a
group or a mesh's data shard of any interchange by replay of one CUDA
graph per key,
and a bits group of several parts by replay of a sweep graph and one
graph per part, `models/graphs.py`, whose inputs the H2D submission lands
in; on the CPU the same bodies run eagerly):
- bits: delta unpack (delta wire), kernel K1 (chunk Huffman decode),
  assembly (DC prefix sums, raster placement), then reconstruction: the
  exact int32 IDCT (kernel E1) or kernel K2 by precision, then
  upsampling and color, or K2 and kernel K3 on "planar-pallas";
- prefix: the zigzag prefix and residuals rebuilt into stores (kernel P1,
  `entropy/prefix.py`), then the same reconstruction;
- lossless: the predictor closed forms or kernel L1, then the interleave.

Batches (`decode_stream(batch_size=N)`, the reference's grouping loop,
`jpeg_decoder_tpu/models/stream.py:1619-1715`, on one device): consecutive
images join a group of up to N while their key matches, and every device
step runs once per group:
- bits: one scan that covers every component, the same Huffman tables,
  kept components and wire (`_bits_group_key`; images of at most 0.25
  Mpix by default only need the tables and the MCU pattern to match,
  `_bits_hetero_key`, so mixed sizes from one encoder share a group). The
  wires merge on the host (`merge_image_packs_delta`, `merge_anchor_wires`)
  and go to the device in one copy per array, then one K1 sweep decodes
  every image, assembly and reconstruction run once per (plan, geometry)
  over that part's rows (K2 and K3 one launch each, per-image tables in
  K2's segment table); the sweep and each part are the two halves of one
  body (`_sweep_body`, `_part_body`; `GroupHalves`), each replayed from
  its key's graph on a card (a part's graph holds a count bucket of
  images, `_batch_bucket`, and takes its rows by a copy);
- lossless: the same `StagedLossless.group_key`; the planes stack as
  [N * C, H, W] through one `reconstruct_planes` (one L1 launch where the
  predictor needs it);
- prefix: the same geometry; one store rebuild, one reconstruction.
Every image comes out bit-equal to its one-image decode, as a view of its
group's [N, ...] output (the view keeps the group's tensor alive, as the
reference's `out[i]` does). A `None` slot (on_error="none") flushes every
open group first, so outputs stay in source order. A same-plan bits
group is not padded to a bucket of sizes: its size is in its graph's key,
so a stream's short last group captures a graph of its own once, where a
padded image would be wasted work on every replay. Prefix and lossless
groups are padded as the reference pads them (`graphs.batch_bucket`; the
prefix residuals to `_bucket` of the longest list), the pad rows the last
image's and never returned, since their keys are the reference's; so are
a hetero group's parts (`_compiled_nat_reconstruct`: a part's graph
decodes its count bucket of images), and the sweep's block count is
bucketed, so that a new composition of known sizes finds its graphs.

On a mesh (`DeviceStreamDecoder(mesh=...)`, the reference's mesh mode,
`jpeg_decoder_tpu/models/stream.py:1243-1317`, `:1856-1995`), bits groups
key on the reference's mesh key (the whole plan and the LUT bytes: no
merge across plans), and each group splits over the mesh's data axis as
the reference shards it: `_batch_bucket(n)` rounded up to a multiple of
the axis size sets the rows per device, and each device runs the group
path above on its rows (its padding rows hold no image and are not
decoded), through the graph cache of its device (one a distinct device:
the slots of one card share one, so a key replays once per shard from its
second call on). `decode_striped` decodes one image's MCU rows across a
stripe axis (`parallel/stripe_bits.py`: one "stripes" graph a call where
the line is one device). On a mesh across processes
(`parallel/dist.py`) the decode is SPMD, as the reference's under
`jax.distributed`: every process gets the same sources and stages them,
runs only its own shards (each on its device's cache), and holds
`Remote(rank)` in the places of the other processes' images.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import time
from typing import Iterable

import numpy as np
import torch

from ..entropy.assemble import GeneralMaps, assemble_nat
from ..entropy.chunk_decode import decode_chunks, unpack_delta
from ..entropy.prefix import prefix_stores
from ..host.decoder import Decoder
from ..host.entropy.prescan import AnchoredScan, PrescanFallback, _bucket_up
from ..host.entropy.transcode import transcode_decoded
from ..host.entropy.wire import (WORDS_PAD, anchor_meta, merge_anchor_wires,
                                 merge_image_packs_delta, pack_delta)
from ..host.errors import FormatError, JpegError
from ..host.ops.pipeline import ImageGeometry, geometry_from_frame
from ..host.ops.tail import is_420_ycbcr
from ..host.parser import CodingProcess, Predictor
from ..host.staging import (BitstreamCapture, StagedImage, StagedLossless,
                            _bucket, _LosslessCapture,
                            _staged_lossless_from_capture, stage_host)
from ..ops.pipeline import reconstruct, reconstruct_planar_pallas
from . import graphs
from ..ops.predictors import reconstruct_planes
from ..parallel.dist import Remote, Shard
from ..parallel.mesh import mesh_device
from ..parallel.stripe_bits import check_engine, decode_bits_striped
from ..params import DeviceParams
from ..transfer import checked_device, put
from ..utils import link
from ..utils.timing import timed_stage

LAYOUTS = ("interleaved", "planar", "planar-pallas")
PRECISIONS = ("fast", "exact")
INTERCHANGES = ("bits", "prefix")


@dataclasses.dataclass
class StagedScan:
    """One scan on its wire: the 4 B/chunk delta wire (`ab` and `base`
    None: the device rebuilds them from `dm`; `cnts` and `shapes` are
    `pack_delta`'s class counts and shapes, which its merge reads), or the
    12 B/chunk anchor wire (`dm` holds `budget << 4 | slot`, `ab` and
    `base` ride beside)."""
    scan: AnchoredScan   # the host prescan's staging: plan, tables, n_blocks
    kept: tuple          # ((scan component position, frame component), ...)
    words: np.ndarray    # int32 stream words, zero-padded
    dm: np.ndarray       # int32 per-chunk wire words
    s_max: int           # symbol steps that bound every chunk
    ab: np.ndarray = None     # int32 [n] entry bits (uint32 patterns)
    base: np.ndarray = None   # int32 [n] first stream block of each chunk
    cnts: np.ndarray = None   # int32 per-class chunk counts (delta wire)
    shapes: tuple = None      # ((slot_words, s_max, n_bucket, n_items), ...)

    @property
    def wire(self) -> str:
        return "delta" if self.ab is None else "anchor"


@dataclasses.dataclass
class StagedBits:
    """One image staged for the device: its scans plus reconstruction
    geometry and quantization tables."""
    geometry: ImageGeometry
    scans: tuple         # (StagedScan, ...)
    qts: tuple           # uint16[64] natural order, per frame component
    mpix: float


def _anchor_scan(scan: AnchoredScan, kept: tuple) -> StagedScan:
    """The 12 B/chunk anchor wire: the fields the reference's XLA engine
    takes (`anchor_bits`, `anchor_block`, `anchor_slot`), in K1's layout."""
    n = scan.n_items
    dm = anchor_meta(scan.anchor_block[1:n + 1].astype(np.int64)
                     - scan.anchor_block[:n], scan.anchor_slot[:n])
    if scan.chunk_syms is not None and n:
        s_max = int(scan.chunk_syms[:n].max())
    else:
        s_max = scan.plan.s_max
    return StagedScan(
        scan, kept,
        words=np.ascontiguousarray(scan.words[:max(scan.n_words, 1)],
                                   np.uint32).view(np.int32),
        dm=dm,
        s_max=max(s_max, 1),
        ab=np.ascontiguousarray(scan.anchor_bits[:n], np.uint32)
        .view(np.int32),
        base=scan.anchor_block[:n].astype(np.int32))


def _wire_scan(scan: AnchoredScan, kept: tuple) -> StagedScan:
    """The delta wire where `pack_delta` takes the scan (the reference's
    first choice, `_attach_pallas`), else the anchor wire."""
    packed = pack_delta(scan)
    if packed is None:
        return _anchor_scan(scan, kept)
    (words, dm, cnts), shapes = packed
    if len(words) < scan.n_words + WORDS_PAD:
        raise FormatError("delta wire without its zero word padding")
    return StagedScan(scan, kept, words, dm,
                      max(s_max for (_sw, s_max, _nb, _ni) in shapes),
                      cnts=cnts, shapes=shapes)


def _port_bits(st) -> StagedBits:
    """The host copy's StagedBits (from `transcode_decoded`) on the port's
    wires."""
    return StagedBits(st.geometry,
                      tuple(_wire_scan(s, kept) for s, kept in st.scans),
                      st.qts, st.mpix)


def _stage_host_decoded_bits(source, scale_to, precision: str,
                             pool_width: int = 1):
    """Full host decode into dense stores, then transcode into the bits
    interchange; prefix fallback when the transcoder declines (the
    reference's `_stage_host_decoded_bits`)."""
    d = Decoder(source, backend="numpy")
    if scale_to is not None:
        d.scale(*scale_to)
    d._decode_entropy_only()
    st = transcode_decoded(d, precision)
    if st is not None:
        return _port_bits(st)
    return stage_host(source, scale_to, precision, pool_width=pool_width)


def stage_host_bits(source, scale_to=None, precision: str = "fast",
                    timer=None, pool_width: int = 1):
    """Stage one JPEG (bytes, path or file-like) for the device: a
    StagedBits, or a StagedLossless (SOF3), or a StagedImage (the prefix
    interchange) for what the bits wire cannot carry. `timer` (a
    `utils.timing.StageTimer`) records this as the "host_stage" stage;
    `pool_width` reaches the prefix fallback's anchored-thread gate (see
    `stage_host`). The reference's signature (`stream.py:616-617`)."""
    if timer is not None:
        with timer.stage("host_stage"):
            return stage_host_bits(source, scale_to, precision, None,
                                   pool_width)
    d = Decoder(source, backend="numpy")
    capture = BitstreamCapture()
    d._prefix_capture = capture
    ll_cap = _LosslessCapture()
    d._lossless_capture = ll_cap
    try:
        if scale_to is not None:
            d.scale(*scale_to)
        d._decode_entropy_only()
    except PrescanFallback:
        return _stage_host_decoded_bits(source, scale_to, precision,
                                        pool_width)
    if ll_cap.scans:
        return _staged_lossless_from_capture(d, ll_cap)
    if not capture.used:
        if d.frame is not None \
                and d.frame.coding_process == CodingProcess.DCT_PROGRESSIVE:
            st = transcode_decoded(d, precision)
            if st is not None:
                return _port_bits(st)
        return stage_host(source, scale_to, precision, pool_width=pool_width)

    frame = d.frame
    n = len(frame.components)
    if any(i not in d._pending_render for i in range(n)):
        raise FormatError("not all components have data")
    transform = None if n == 1 else d._determine_color_transform()
    geometry = geometry_from_frame(frame, transform, precision=precision)
    qts = tuple(d._pending_render[i][1] for i in range(n))
    info = d.info()
    return StagedBits(geometry,
                      tuple(_wire_scan(s, kept) for s, kept in capture.scans),
                      qts, info.width * info.height / 1e6)


def merge_scans(scans: list):
    """`_merge` without the merged class shapes."""
    merged = _merge(scans)
    return None if merged is None else merged[:3]


def _merge(scans: list):
    """One wire for the scans of a group of images, all on one wire, in
    order: (arrays, s_max, n_blocks), the arrays being (words, dm) of the
    delta wire (`merge_image_packs_delta`) or (words, dm, ab, base) of the
    anchor wire (`merge_anchor_wires`), s_max the most steps any image's
    chunks need and n_blocks the images' blocks together. None when the
    merge declines (a field would overflow at an image boundary, a mix of
    single- and multi-class packs, a stream past 2^26 words, scans on
    different wires, which a mesh group's key allows): the images
    then decode one by one, each on its own wire. The delta wire places an
    image's chunks by the budgets of the images before it, so an image
    whose budgets do not sum to its blocks is declined too. A fourth item
    holds the delta wire's merged class shapes (None on the anchor
    wire)."""
    nbs = [s.scan.plan.n_blocks for s in scans]
    if len({s.wire for s in scans}) > 1:
        return None
    if scans[0].wire == "anchor":
        merged = merge_anchor_wires([(s.words, s.dm, s.ab, s.base, nb)
                                     for s, nb in zip(scans, nbs)])
        if merged is None:
            return None
        return merged, max(s.s_max for s in scans), sum(nbs), None
    for s, nb in zip(scans, nbs):
        n = int(s.cnts.sum())
        if int(((s.dm[:n].view(np.uint32) >> 4) & 31).sum()) != nb:
            return None
    merged = merge_image_packs_delta(
        [((s.words, s.dm, s.cnts), s.shapes) for s in scans], nbs)
    if merged is None:
        return None
    (words, dm, _cnts), shapes = merged
    return ((words, dm), max(sm for (_sw, sm, _nb, _ni) in shapes), sum(nbs),
            shapes)


def _bits_hetero_key(st: StagedBits):
    """The reference's `_bits_hetero_key` (`stream.py:1073`): images sharing
    it merge into ONE K1 sweep even with different plans and geometries
    (mixed sizes from one encoder); assembly and reconstruction then run
    per plan over its part of the sweep's rows. None: decode singly."""
    if len(st.scans) != 1:
        return None
    s = st.scans[0]
    if len(s.kept) != len(st.qts):
        return None
    scan = s.scan
    mapped_pattern = tuple(scan.comp_to_upair[c] for c in scan.plan.pattern)
    return (mapped_pattern, s.kept, len(st.qts), s.wire,
            scan.tab_maxcode.tobytes(), scan.tab_delta.tobytes(),
            scan.tab_values.tobytes())


def _bits_group_key(st: StagedBits, mesh_mode: bool = False):
    """The reference's `_bits_group_key` (`stream.py:1094`): images sharing
    it merge into one batched bits dispatch: one scan covering every
    component, the same geometry, Huffman tables, kept components and
    wire. With `mesh_mode` (a decoder with a mesh), the reference's mesh
    key: the geometry, the whole plan (its buckets included), the kept
    components, the component count and the LUT bytes. None: decode
    singly."""
    if len(st.scans) != 1:
        return None
    s = st.scans[0]
    if len(s.kept) != len(st.qts):
        return None
    scan = s.scan
    if mesh_mode:
        if scan.luts is None:
            return None
        return (st.geometry, scan.plan, s.kept, len(st.qts),
                scan.luts.tobytes())
    return (st.geometry, scan.plan._key[:-3], s.kept,
            tuple(scan.comp_to_upair), len(st.qts), s.wire,
            scan.tab_maxcode.tobytes(), scan.tab_delta.tobytes(),
            scan.tab_values.tobytes(), scan.luts.shape)


def _hetero_threshold() -> float:
    """Mpix at or below which bits images group by `_bits_hetero_key`, from
    JPEG_TPU_HETERO_BITS as the reference reads it (`stream.py:1686-1695`):
    unset, '' or '1' 0.25; '0' the exact key only; a number that
    threshold; 'auto' 0.0 when the link monitor (`utils.link`) reads a
    degraded link, else 0.25."""
    v = os.environ.get("JPEG_TPU_HETERO_BITS", "1")
    if v == "auto":
        return 0.0 if link.degraded() else 0.25
    return 0.0 if v == "0" else 0.25 if v in ("", "1") else float(v)


# K1's output holds fewer than 2^31 elements (chunk_decode.py).
K1_MAX_BLOCKS = (2 ** 31 - 1) // 64


def lossless_images(st: StagedLossless, diffs: torch.Tensor) -> torch.Tensor:
    """The reference's `_compiled_lossless_pipeline` (vmapped over a
    group): `diffs` holds N images' staged uint16 planes as int16 bit
    patterns, [N, C, H, W], of one `group_key` (`st` is any of them, or
    its `graphs.LosslessShape`). Every
    plane of the group through one `reconstruct_planes` (kernel L1 once
    for the group where the predictor needs it), then the
    element-count-bound interleave per image; uint8 out at precision 8,
    else uint16: [N, H, W] for one component, else [N, H, W, C]."""
    n, ncomp, h, w = diffs.shape
    d = diffs.to(torch.int32) & 0xFFFF
    planes = reconstruct_planes(d.reshape(n * ncomp, h, w),
                                Predictor(st.predictor), st.point_transform,
                                st.precision, st.restart_all)
    planes = planes.reshape(n, ncomp, h * w)
    if ncomp == 1:
        img = planes.reshape(n, h, w)
    else:
        count = st.out_width * st.out_height
        img = planes[..., :count].transpose(1, 2).reshape(
            n, st.out_height, st.out_width, ncomp)
    return img.to(torch.uint8 if st.precision == 8 else torch.uint16)


def _prefix_wire(group: list, images: int) -> tuple:
    """A prefix group's wire, `images` rows of one geometry (the rows past
    the group's take its last image's, as the reference pads a group):
    dc [B, n], ac [B, n, 15], and the residuals [B, width] (`_bucket` of the
    longest list), each index into the rows' stores flattened row after
    row (row i's offset by i times an image's coefficients, a negative one
    counted from its row's end, as `mode="drop"` reads it) and every other
    one at the sink `images x total`, past every row: dropped."""
    rows = group + [group[-1]] * (images - len(group))
    total = group[0].dc.shape[-1] * 64     # one image's coefficients
    width = _bucket(max(len(st.resid_idx) for st in group))
    ri = np.full((images, width), images * total, np.int64)
    rv = np.zeros((images, width), np.int16)
    for i, st in enumerate(rows):
        idx = st.resid_idx.astype(np.int64)
        idx = np.where(idx < 0, idx + total, idx)
        ri[i, :len(idx)] = np.where((idx >= 0) & (idx < total),
                                    idx + i * total, images * total)
        rv[i, :len(idx)] = st.resid_vals
    return (np.stack([st.dc for st in rows]),
            np.stack([st.ac for st in rows]), ri.astype(np.int32), rv)


@dataclasses.dataclass
class GroupHalves:
    """A bits group's device half as the reference's hetero dispatch splits
    it: `sweep`, every image's K1 over the merged wire, and per (plan,
    geometry) part in `parts` (its images, first seen first) its entry of
    `recons`, the assembly and reconstruction of its rows of the sweep's
    nat. Each half is a `graphs.Fill` of its key's graph or a
    (`graphs.BodyShape`, `graphs.Inputs`) pair run eagerly."""
    parts: dict
    sweep: object
    recons: list


def _kind(staged) -> str:
    if isinstance(staged, StagedBits):
        return "bits"
    if isinstance(staged, StagedLossless):
        return "lossless"
    if isinstance(staged, StagedImage):
        return "prefix"
    raise TypeError(f"not a staged image: {type(staged).__name__}")


class DeviceStreamDecoder:
    """Streaming decode to tensors on `device` ("cuda", the default,
    "cuda:N", or "cpu" when the caller asks for it). On the CPU the
    kernels' plain PyTorch versions run; on a CUDA device the hand-written
    kernels do. Asking for CUDA where there is no card raises.

    `mesh` (`parallel.make_mesh`; `device` then stays at its default or
    names the mesh's first device): the reference's
    `DeviceStreamDecoder(mesh=, data_axis=)`. Batched groups split over
    the mesh's `data_axis` (`_decode_group_mesh`), each image's tensor on
    its shard's device; `decode_striped` splits one image's MCU rows over
    a "stripe" axis; all other work runs on the mesh's first device, the
    counterpart of the reference's default device.

    `timer`: optional `utils.timing.StageTimer`; records "host_stage"
    (parse + entropy/prescan + pack, per image, in the staging threads),
    "h2d_submit" (the wire's host-to-device submission, per image or
    group) and "device_dispatch" (enqueueing the device work), as the
    reference's does. Device execution itself is asynchronous: end-to-end
    wall time is the caller's to measure after a synchronisation."""

    def __init__(self, *, device="cuda", host_threads: int = 4,
                 precision: str = "fast", layout: str = "interleaved",
                 interchange: str = "bits", timer=None, mesh=None,
                 data_axis: str = "data"):
        dev = checked_device(device) if mesh is None \
            else mesh_device(mesh, device)
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}; one of "
                             f"{PRECISIONS}")
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")
        if interchange not in INTERCHANGES:
            raise ValueError(f"unknown interchange {interchange!r}; one of "
                             f"{INTERCHANGES}")
        self.device = dev
        self.precision = precision
        self.layout = layout
        self.interchange = interchange
        self.host_threads = host_threads
        self.timer = timer
        self.mesh = mesh
        self.data_axis = data_axis
        self.params = DeviceParams(dev) if mesh is None else mesh.params(dev)
        self._maps: dict = {}
        # The graphs, one per key, in one cache per distinct device this
        # process runs on: the decoder's, or each of the mesh's (its slots
        # of one card share one); `_graphs` the decoder's device's.
        self._caches = {d: graphs.BitsGraphs(d, self._params_of(d),
                                             self._general_maps)
                        for d in self._local_devices()}
        self._graphs = self._caches[dev]
        self.pool = cf.ThreadPoolExecutor(max_workers=host_threads)

    def close(self) -> None:
        self.pool.shutdown(wait=True)
        for cache in self._caches.values():
            cache.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stage(self, source, scale_to=None):
        """Host stage of one image, by the decoder's interchange."""
        if self.interchange == "bits":
            return stage_host_bits(source, scale_to, self.precision,
                                   self.timer, self.host_threads)
        return stage_host(source, scale_to, self.precision, self.timer,
                          pool_width=self.host_threads)

    def _params_of(self, dev) -> DeviceParams:
        """The constants' copies on `dev`: one `DeviceParams` per device
        (the mesh's, on a mesh)."""
        return self.params if self.mesh is None else self.mesh.params(dev)

    def _local_devices(self) -> list:
        """The distinct devices this process runs on: the decoder's, or
        the mesh's entries this process holds, in mesh order."""
        if self.mesh is None:
            return [self.device]
        local = self.mesh.devices[self.mesh.owners == self.mesh.rank]
        return list(dict.fromkeys(local.tolist()))

    def _graphs_of(self, dev):
        """The graph cache of `dev` (by default the decoder's device), or
        None for a device this process does not run on."""
        return self._graphs if dev is None \
            else self._caches.get(checked_device(dev))

    def _put_recorded(self, arrs, dev=None) -> tuple:
        """One H2D submission of a tuple of host arrays (`transfer.put`:
        non-blocking through one pinned buffer on a CUDA device), folding
        its rate into `utils.link`'s EMA when the payload is big enough to
        time bandwidth (the reference's `_put_recorded`). Never adds a
        synchronisation: the time is the pinned copy's and the enqueue's,
        so on a card the rate passes the link model's cap and is dropped
        by construction."""
        nbytes = sum(a.nbytes for a in arrs)
        t0 = time.perf_counter()
        out = put(arrs, self.device if dev is None else dev)
        if nbytes >= (4 << 20):
            link.record_transfer(nbytes, time.perf_counter() - t0)
        return out

    def _to_device(self, staged, dev=None):
        """One H2D submission of one image's staged wire (to `dev`, by
        default the decoder's device). The image lands in its key's graph
        of `dev`'s cache with its tables (a `graphs.Fill`), but at the
        key's first sight on a card; then the wire's device tensors
        (`_wire_tensors`)."""
        kind = _kind(staged)
        cache = self._graphs_of(dev)
        if cache is not None:
            fill = self._bits_fill(staged, cache) if kind == "bits" \
                else self._padded_fill(kind, staged, cache)
            if fill is not None:
                return fill
        return self._wire_tensors(staged, dev)

    def _wire_tensors(self, staged, dev=None) -> tuple:
        """One image's staged wire in one H2D submission to `dev` (by
        default the decoder's device), off any graph: per scan its (words,
        dm[, ab, base]) on a bits image, else the prefix or lossless
        wire's tensors."""
        kind = _kind(staged)
        if kind == "bits":
            flat = self._put_recorded(tuple(
                a for s in staged.scans
                for a in ((s.words, s.dm) if s.ab is None
                          else (s.words, s.dm, s.ab, s.base))), dev)
            wires, i = [], 0
            for s in staged.scans:
                n = 2 if s.ab is None else 4
                wires.append(flat[i:i + n])
                i += n
            return tuple(wires)
        if kind == "lossless":
            return self._put_recorded((staged.diffs.view(np.int16),), dev)
        return self._put_recorded((staged.dc, staged.ac, staged.resid_idx,
                                   staged.resid_vals), dev)

    def _put_into(self, fill_fn):
        """`fill_fn()`, a graph's H2D submission, timed for `utils.link` as
        `_put_recorded` times a put."""
        t0 = time.perf_counter()
        fill = fill_fn()
        nbytes = sum(a.nbytes for _o, a in fill.items)
        if nbytes >= (4 << 20):
            link.record_transfer(nbytes, time.perf_counter() - t0)
        return fill

    def _fp32(self, geometry) -> bool:
        """K2 (float32, folded tables) for the IDCT, else E1: as
        `ops.pipeline._pixels` chooses."""
        return self._effective_layout(geometry) == "planar-pallas" \
            or geometry.precision == "fast"

    def _bits_fill(self, staged, cache):
        """One bits image's wires, tables and quantisation tables into its
        key's graph of `cache`, in one H2D submission (a `graphs.Fill`);
        None at the key's first sight on a card
        (`graphs.BitsGraphs.first_sight`)."""
        layout = self._effective_layout(staged.geometry)
        key = graphs.bits_key(staged, self.precision, layout)
        if cache.first_sight(key):
            return None
        shape = graphs.image_shape(staged, self._fp32(staged.geometry))
        wires = [graphs.wire_arrays(s.wire, graphs._scan_arrays(s),
                                    s.scan.plan.n_blocks)
                 for s in staged.scans]
        return self._put_into(lambda: cache.fill(
            key, shape, wires, [s.scan for s in staged.scans],
            [staged.qts]))

    def _padded_fill(self, kind: str, staged_or_group, cache):
        """A prefix or lossless image's wire (or a group's, its rows padded
        to its count bucket with the last image's, as the reference pads a
        group: `_prefix_wire` on prefix), with a prefix image's
        quantisation tables, into its key's graph of `cache` in one H2D
        submission (a `graphs.Fill` that returns the group's images); None
        at the key's first sight on a card."""
        group = isinstance(staged_or_group, list)
        rows = staged_or_group if group else [staged_or_group]
        first = rows[0]
        key = graphs.lossless_key(staged_or_group) if kind == "lossless" \
            else graphs.prefix_key(staged_or_group, self.precision,
                                   self._effective_layout(first.geometry))
        if cache.first_sight(key):
            return None
        images = key[-1] or 1
        padded = rows + [rows[-1]] * (images - len(rows))
        if kind == "lossless":
            shape, qts = graphs.lossless_shape(first, images), []
            wire = (np.stack([st.diffs for st in padded]).view(np.int16),)
        else:
            shape = graphs.prefix_shape(first, images,
                                        self._fp32(first.geometry))
            qts = [st.qts for st in padded]
            wire = _prefix_wire(rows, images) if group else (
                first.dc[None], first.ac[None], first.resid_idx[None],
                first.resid_vals[None])
        return self._put_into(lambda: cache.fill(
            key, shape, [wire], [], qts, len(rows)))

    def _general_maps(self, plan, dev):
        maps = self._maps.get((plan, dev))
        if maps is None:
            if len(self._maps) > 64:
                self._maps.clear()
            maps = self._maps[plan, dev] = GeneralMaps(plan, dev)
        return maps

    def _effective_layout(self, geometry) -> str:
        """planar-pallas downgrades to plain planar for geometries the fused
        tail doesn't cover: one rule for every dispatch shape."""
        if self.layout == "planar-pallas" and not is_420_ycbcr(geometry):
            return "planar"
        return self.layout

    def _reconstruct(self, geometry, stores, qts_b, params=None
                     ) -> torch.Tensor:
        """Stores of N images of one geometry ([N, blocks, 64] per
        component, on one device) and their tables -> [N, ...] in the
        decoder's layout, on that device. `params`: where the tables come
        from (by default the device's `DeviceParams`)."""
        layout = self._effective_layout(geometry)
        if params is None:
            params = self._params_of(stores[0].device)
        with torch.profiler.record_function("reconstruct"):  # K3: fused_tail
            if layout == "planar-pallas":
                return reconstruct_planar_pallas(geometry, stores, qts_b,
                                                 params)
            return reconstruct(geometry, stores, qts_b, params,
                               planar=layout == "planar")

    def _decode_scan(self, wire_kind: str, wire: tuple, tables, s_max: int,
                     n_blocks: int) -> torch.Tensor:
        """K1 over a scan's wire on the device (one image's, or a group's
        merged one), with its `tables`: int16 nat [n_blocks, 64]."""
        span = torch.profiler.record_function   # layer names in traces
        if wire_kind == "delta":
            words, dm = wire
            with span("unpack_delta"):
                ab, base = unpack_delta(dm)
        else:
            words, dm, ab, base = wire
        with span("k1_decode"):
            return decode_chunks(words, dm, ab, base, tables, s_max,
                                 n_blocks)

    def _assemble(self, nat: torch.Tensor, plan, kept: tuple, stores: list,
                  maps=None) -> None:
        """Assembly of nat [N, n_blocks, 64] (N images of `plan`) into
        `stores`, by frame component (`kept`): [N, blocks, 64] each.
        `maps`: a general plan's index maps (by default the decoder's)."""
        with torch.profiler.record_function("assemble"):
            if maps is None and plan.structured is None:
                maps = self._general_maps(plan, nat.device)
            scan_stores = assemble_nat(nat, plan, maps)
        for pos, comp_i in kept:
            stores[comp_i] = scan_stores[pos]

    def _sweep_body(self, shape: "graphs.BodyShape",
                    inputs: "graphs.Inputs") -> list:
        """The first half of the bits device half: every scan's K1 (after
        U1 on the delta wire) over its wire, one nat per scan, int16
        [n_blocks, 64] in stream block order. A hetero group's sweep graph
        runs it alone (`graphs.sweep_shape`)."""
        return [self._decode_scan(scan.wire, wire, tables, scan.s_max,
                                  scan.n_blocks)
                for scan, wire, tables in zip(shape.scans, inputs.wires,
                                              inputs.tables)]

    def _part_body(self, shape: "graphs.BodyShape", nats: list,
                   inputs: "graphs.Inputs") -> torch.Tensor:
        """The second half: per scan A1 of its nat (the `shape.images`
        images' rows, [N x n_blocks, 64]), then the reconstruction of the
        images: [N, ...] in the decoder's layout. A hetero group's part
        graph runs it alone (`graphs.part_shape`), on its `nat_in`."""
        n = shape.images
        stores = [None] * shape.ncomp
        for scan, nat, maps in zip(shape.scans, nats, inputs.maps):
            self._assemble(nat.view(n, scan.plan.n_blocks, 64), scan.plan,
                           scan.kept, stores, maps)
        return self._reconstruct(shape.geometry, stores, inputs.qts_b,
                                 inputs.params)

    def _bits_body(self, shape: "graphs.BodyShape",
                   inputs: "graphs.Inputs") -> torch.Tensor:
        """The device half of a graph's key on its inputs: the sweep, then
        the part, back to back: [N, ...] in the decoder's layout. What
        `graphs.BitsGraphs` runs eagerly or captures for one image or a
        group of one (plan, geometry), and what a bits image off a graph
        (a key's first call on a card, `_wire_tensors`) runs on the
        device's `DeviceParams`."""
        return self._part_body(shape, self._sweep_body(shape, inputs),
                               inputs)

    def _prefix_body(self, shape: "graphs.BodyShape",
                     inputs: "graphs.Inputs") -> torch.Tensor:
        """The device half of a prefix image or group: P1 over its wire
        (`entropy/prefix.py`), then the reconstruction of its
        `shape.images` images, as `_part_body` runs it: [N, ...] in the
        decoder's layout. What `graphs.BitsGraphs` runs eagerly or
        captures, and what a prefix image or group off a graph runs on the
        device's `DeviceParams`."""
        with torch.profiler.record_function("prefix_stores"):
            stores = prefix_stores(shape.geometry, *inputs.wires[0])
        return self._reconstruct(shape.geometry, stores, inputs.qts_b,
                                 inputs.params)

    def _lossless_body(self, shape: "graphs.BodyShape",
                       inputs: "graphs.Inputs") -> torch.Tensor:
        """The device half of a lossless image or group: `lossless_images`
        of its planes, int16 [N, C, H, W]: [N, ...]."""
        with torch.profiler.record_function("lossless"):
            return lossless_images(shape.geometry, inputs.wires[0][0])

    def _eager_body(self, kind: str, group: list, wire: tuple
                    ) -> torch.Tensor:
        """The prefix or lossless body of `group` off any graph: its wire
        on the device, the tables from that device's `DeviceParams`."""
        if kind == "lossless":
            return self._lossless_body(
                graphs.lossless_shape(group[0], len(group)),
                graphs.Inputs([wire], [], [], [], None))
        return self._prefix_body(
            graphs.prefix_shape(group[0], len(group),
                                self._fp32(group[0].geometry)),
            graphs.Inputs([wire], [], [], [st.qts for st in group],
                          self._params_of(wire[0].device)))

    def _run_device(self, staged, wires) -> torch.Tensor:
        """The device half for one image whose wire is already on the
        device: its key's graph (`_to_device`'s `graphs.Fill`), by replay
        on a card, or its body off any graph. Enqueues work only: no host
        synchronisation."""
        if isinstance(wires, graphs.Fill):
            return wires.run(self)[0]
        kind = _kind(staged)
        if kind == "lossless":
            return self._eager_body(kind, [staged], (wires[0][None],))[0]
        if kind == "prefix":
            return self._eager_body(kind, [staged], tuple(wires))[0]
        params = self._params_of(wires[0][0].device)
        return self._bits_body(
            graphs.image_shape(staged, self._fp32(staged.geometry),
                               keyed=False),
            graphs.Inputs(list(wires),
                          [params.tables(st.scan) for st in staged.scans],
                          [None] * len(staged.scans), [staged.qts],
                          params))[0]

    def _run_device_eager(self, staged, wires) -> torch.Tensor:
        """`_run_device` with a graph's body run eagerly on its inputs, not
        replayed: the eager dispatch the replay stands for."""
        if isinstance(wires, graphs.Fill):
            return wires.run(self, eager=True)[0]
        return self._run_device(staged, wires)

    def decode_one(self, staged, dev=None) -> torch.Tensor:
        """Decode one staged image (bits, prefix or lossless), on `dev` (by
        default the decoder's device)."""
        with timed_stage(self.timer, "h2d_submit"):
            wires = self._to_device(staged, dev)
        with timed_stage(self.timer, "device_dispatch"):
            return self._run_device(staged, wires)

    def decode_striped(self, source, scale_to=None,
                       stripe_axis: str = "stripe", engine: str = None):
        """Decode ONE image with its MCU rows, entropy decode included,
        split over the mesh's `stripe_axis` (`parallel/stripe_bits.py`):
        each device Huffman-decodes its stripe's anchored chunks, assembles
        with the DC seam carry and reconstructs behind a 1-row halo
        exchange, always at the exact integer IDCT, in the interleaved
        layout (the reference's `decode_striped`, `stream.py:1296`).
        Returns one tensor on the mesh's first device, the stripes' rows
        gathered there (the reference returns an array sharded on rows);
        on a mesh across processes, this process's `Shard`s of the rows.
        Falls back to `decode_one` when there is no mesh, the mesh has no
        such axis or the image declines (on a mesh across processes, the
        whole image as this process's one `Shard`). `engine`: None or
        "xla" (`stripe_bits.check_engine`)."""
        check_engine(engine)
        staged = stage_host_bits(source, scale_to, self.precision,
                                 self.timer, self.host_threads)
        if (self.mesh is not None and stripe_axis in self.mesh.shape
                and isinstance(staged, StagedBits)):
            with timed_stage(self.timer, "device_dispatch"):
                out = decode_bits_striped(staged, self.mesh, stripe_axis)
            if out is not None:
                return out
        img = self.decode_one(staged)
        if self.mesh is not None and self.mesh.processes > 1:
            return [Shard((slice(0, img.shape[0]),), img)]
        return img

    # Groups: `_group_wires` merges a group's wires on the host and submits
    # them to the device in one copy; `_run_group` enqueues the device work.

    def _group_wires(self, kind: str, group: list, dev=None):
        """The group's merged wire on `dev` (by default the decoder's
        device), or None when the host merge declines (the images then
        decode one by one). A bits group of one (plan, geometry), and a
        prefix or lossless group, lands in its key's graph of `dev`'s
        cache with its tables (a `graphs.Fill`), but at the key's first
        sight on a card; a bits group of several parts lands in its
        halves' graphs (`GroupHalves`)."""
        cache = self._graphs_of(dev)
        if kind == "bits":
            parts, merged = self._bits_merge(group)
            if merged is None:
                return None
            if len(parts) == 1 and cache is not None:
                fill = self._group_fill(group, merged, cache)
                if fill is not None:
                    return fill
            return self._group_halves(group, parts, merged, dev,
                                      cache if len(parts) > 1 else None)
        if kind == "prefix" and graphs.batch_bucket(len(group)) \
                * group[0].dc.shape[-1] * 64 >= 2 ** 31:
            return None         # P1's indices would pass int32
        if cache is not None:
            fill = self._padded_fill(kind, group, cache)
            if fill is not None:
                return fill
        if kind == "lossless":
            return self._put_recorded(
                (np.stack([st.diffs for st in group]).view(np.int16),), dev)
        return self._put_recorded(_prefix_wire(group, len(group)), dev)

    def _bits_merge(self, group: list) -> tuple:
        """A bits group's parts ({(plan, geometry): its images' indices},
        in the order first seen) and its merged wire (`_merge` of the
        images part after part; None where the host merge declines)."""
        parts: dict = {}
        for i, st in enumerate(group):
            parts.setdefault((st.scans[0].scan.plan, st.geometry),
                             []).append(i)
        order = [i for members in parts.values() for i in members]
        return parts, _merge([group[i].scans[0] for i in order])

    def _group_fill(self, group: list, merged, cache):
        """A same-plan bits group's merged wire, its tables and every
        image's quantisation tables into its key's graph of `cache`, in
        one H2D submission (a `graphs.Fill`); None at the key's first
        sight on a card."""
        geometry = group[0].geometry
        st0 = group[0].scans[0]
        key = graphs.bits_key(group, self.precision,
                              self._effective_layout(geometry), merged)
        if cache.first_sight(key):
            return None
        shape = graphs.group_shape(group, merged, self._fp32(geometry))
        wire = graphs.wire_arrays(st0.wire, merged[0], merged[2])
        return self._put_into(lambda: cache.fill(
            key, shape, [wire], [st0.scan], [st.qts for st in group]))

    def _group_halves(self, group: list, parts: dict, merged, dev,
                      cache) -> "GroupHalves":
        """A bits group's device half in its two halves (`GroupHalves`):
        with a `cache` (a group of several parts) the sweep's and each
        part's inputs land in their keys' graphs of it, one H2D submission
        an arena (`graphs.Fill`s); a half whose key is at its first sight
        on a card, and every half without a `cache`, runs eagerly: the
        merged wire in one H2D submission to `dev`, the tables from the
        device's `DeviceParams`."""
        arrays, s_max, n_blocks, shapes = merged
        st0 = group[0].scans[0]
        sweep = None
        if cache is not None:
            wire = graphs.wire_arrays(st0.wire, arrays, n_blocks)
            bound = s_max if st0.wire == "delta" \
                else max(st.scans[0].scan.plan.s_max for st in group)
            blocks = min(_bucket_up(sum(
                graphs.batch_bucket(len(members)) * plan.n_blocks
                for (plan, _g), members in parts.items()), 4096),
                K1_MAX_BLOCKS)
            key = graphs.sweep_key(st0, wire, bound, shapes, blocks)
            if not cache.first_sight(key):
                sweep = self._put_into(lambda: cache.fill(
                    key, graphs.sweep_shape(st0, bound, blocks), [wire],
                    [st0.scan], []))
        params = self._params_of(self.device if dev is None else dev)
        if sweep is None:
            put = self._put_recorded(tuple(arrays), dev)
            sweep = (graphs.sweep_shape(st0, s_max, n_blocks),
                     graphs.Inputs([put], [params.tables(st0.scan)], [None],
                                   [], params))
        recons = []
        for members in parts.values():
            first = group[members[0]]
            fp32 = self._fp32(first.geometry)
            fill = self._part_fill(group, members, fp32, cache) \
                if cache is not None else None
            recons.append(fill if fill is not None else (
                graphs.part_shape(first, len(members), fp32),
                graphs.Inputs([], [], [None], [group[i].qts for i in members],
                              params)))
        return GroupHalves(parts, sweep, recons)

    def _part_fill(self, group: list, members: list, fp32: bool, cache):
        """One part's quantisation tables into its key's graph of `cache`,
        a slot per
        image of its count bucket (the pad slots take the last image's, as
        the reference pads them), in one H2D submission (a `graphs.Fill`);
        None at the key's first sight on a card."""
        first = group[members[0]]
        bucket = graphs.batch_bucket(len(members))
        key = graphs.part_key(first, bucket, self.precision,
                              self._effective_layout(first.geometry))
        if cache.first_sight(key):
            return None
        qts = [group[i].qts for i in members]
        qts += [qts[-1]] * (bucket - len(members))
        return self._put_into(lambda: cache.fill(
            key, graphs.part_shape(first, bucket, fp32), [], [], qts))

    def _run_half(self, half, eager: bool, rows=None) -> torch.Tensor:
        """One half of a group (`GroupHalves`): a `graphs.Fill` through its
        graph, else (shape, inputs) run eagerly; the sweep's nat, or with
        `rows` (a part's rows of it) the part's images."""
        if isinstance(half, graphs.Fill):
            return half.run(self, eager, rows)
        shape, inputs = half
        if rows is None:
            return self._sweep_body(shape, inputs)[0]
        return self._part_body(shape, [rows], inputs)

    def _run_halves(self, group: list, halves: "GroupHalves",
                    eager: bool = False) -> list:
        """The sweep, then per part its rows of the sweep's nat through its
        reconstruction: the reference's `_decode_group_bits_hetero`
        dispatch, each part's offset a runtime value. No host
        synchronisation."""
        nat = self._run_half(halves.sweep, eager)
        results = [None] * len(group)
        off = 0
        for members, half in zip(halves.parts.values(), halves.recons):
            rows = len(members) * group[members[0]].scans[0].scan.plan.n_blocks
            out = self._run_half(half, eager, nat[off:off + rows])
            for i, img in zip(members, out):
                results[i] = img
            off += rows
        return results

    def _run_group(self, kind: str, group: list, wires) -> list:
        """The device half of a group whose merged wire is on the device:
        its images' tensors, in the group's order, each a view of one
        [N, ...] output per (plan, geometry) (of a graph's output, copied
        out of it, for a `graphs.Fill` and a part's graph)."""
        if isinstance(wires, graphs.Fill):
            return list(wires.run(self))
        if kind != "bits":
            return list(self._eager_body(kind, group, tuple(wires)))
        return self._run_halves(group, wires)

    def _run_group_eager(self, kind: str, group: list, wires) -> list:
        """`_run_group` with a graph's body run eagerly on its inputs, not
        replayed."""
        if isinstance(wires, graphs.Fill):
            return list(wires.run(self, eager=True))
        if isinstance(wires, GroupHalves):
            return self._run_halves(group, wires, eager=True)
        return self._run_group(kind, group, wires)

    def _decode_group(self, kind: str, group: list, dev=None) -> list:
        """One group, on `dev` (by default the decoder's device): the
        reference's `_decode_group_bits` with `_decode_group_bits_hetero`
        (one K1 sweep, then assembly and reconstruction per plan; a group
        of one plan is the same-key case), `_decode_group_lossless` and
        `_decode_group` (prefix). A bits group whose blocks would pass K1's
        output limit splits."""
        if kind == "bits":
            runs, blocks = [[]], 0
            for st in group:
                nb = st.scans[0].scan.plan.n_blocks
                if runs[-1] and blocks + nb > K1_MAX_BLOCKS:
                    runs.append([])
                    blocks = 0
                runs[-1].append(st)
                blocks += nb
            if len(runs) > 1:
                return [img for run in runs
                        for img in self._decode_group(kind, run, dev)]
        if len(group) == 1:
            return [self.decode_one(group[0], dev)]
        with timed_stage(self.timer, "h2d_submit"):
            wires = self._group_wires(kind, group, dev)
        if wires is None:
            return [self.decode_one(st, dev) for st in group]
        with timed_stage(self.timer, "device_dispatch"):
            return self._run_group(kind, group, wires)

    def _decode_group_mesh(self, kind: str, group: list) -> list:
        """A group on the mesh: the reference's `_decode_group_bits_mesh`,
        and `_decode_group_lossless` and `_decode_group` (prefix) with a
        mesh. The batch is `_batch_bucket(n)` rounded up to a multiple of
        the data axis's size n_d, device k takes rows [k B / n_d,
        (k + 1) B / n_d), and each device runs the one-device group path
        on its rows (one K1 sweep, K2 on its segment table, K3 on
        planar-pallas, L1 for a lossless shard). Rows past the images are
        the reference's padding: no image, so nothing is decoded there.
        Each shard lands in, and from its key's second call replays from,
        its device's graph cache (`_graphs_of`), the slots of one card
        sharing one. Each image's tensor lives on its shard's device. On a
        mesh across processes only this process's shards run, as in the
        reference's SPMD decode; a row of another process's shard is
        `Remote(rank)` and is not read (the caller may leave anything
        there)."""
        out = []
        for dev, owner, (b0, b1) in self.mesh_shards(len(group)):
            rows = group[b0:b1]
            out.extend(self._decode_group(kind, rows, dev)
                       if owner == self.mesh.rank
                       else [Remote(owner)] * len(rows))
        return out

    def mesh_shards(self, n: int) -> list:
        """How a group of n images splits over the mesh's data axis:
        (device, owner rank, (first, end)) per shard that holds images.
        Each process stages only the rows of its own shards when it builds
        a group itself (the reference's process-local staging)."""
        devs = list(self.mesh.axis_devices(self.data_axis))
        owners = self.mesh.axis_owners(self.data_axis)
        per = -(-graphs.batch_bucket(n) // len(devs))
        return [(dev, int(owners[k]), (k * per, min((k + 1) * per, n)))
                for k, dev in enumerate(devs) if k * per < n]

    def decode_stream(self, sources: Iterable, scale_to=None,
                      batch_size: int = 1, on_error: str = "raise") -> list:
        """Decode all sources, in order, to device tensors. The pool stages
        later images on the host while earlier ones decode on the device.

        batch_size > 1 groups consecutive images into one device dispatch
        of up to batch_size images, as the reference does (module
        docstring): every image comes out bit-equal to its one-image
        decode, a view of its group's output tensor (which the view keeps
        alive).

        on_error: "raise" propagates the first failure; any other value
        ("none") isolates a source whose staging raises a JpegError: its
        slot holds None and later sources still decode, as in the
        reference."""
        futures = [self.pool.submit(self.stage, s, scale_to) for s in sources]

        def resolve(fut):
            if on_error == "raise":
                return fut.result()
            try:
                return fut.result()
            except JpegError:
                return None

        try:
            if batch_size <= 1:
                return [None if st is None else self.decode_one(st)
                        for st in map(resolve, futures)]
            return self._grouped(map(resolve, futures), batch_size)
        except BaseException:
            for f in futures:      # stop staging what will not be decoded
                f.cancel()
            raise

    def _grouped(self, staged, batch_size: int) -> list:
        """The reference's grouping loop (`stream.py:1619-1715`): three open
        groups (prefix, bits, lossless) and its flush rules; on a mesh the
        bits key is the mesh key (no merge across plans) and groups split
        over the data axis."""
        thr = _hetero_threshold()
        outputs: list = []
        groups = {"prefix": [], "bits": [], "lossless": []}
        bits_key = [None]
        decode = (self._decode_group if self.mesh is None
                  else self._decode_group_mesh)

        def flush(*kinds):
            for kind in kinds:
                if groups[kind]:
                    outputs.extend(decode(kind, groups[kind]))
                    groups[kind] = []

        for st in staged:
            if st is None:
                flush("prefix", "bits", "lossless")
                outputs.append(None)
                continue
            kind = _kind(st)
            if kind == "lossless":
                flush("prefix", "bits")
                ll = groups["lossless"]
                if ll and (st.group_key != ll[0].group_key
                           or len(ll) >= batch_size):
                    flush("lossless")
                groups["lossless"].append(st)
                continue
            flush("lossless")
            if kind == "bits":
                flush("prefix")
                if self.mesh is not None:
                    key = _bits_group_key(st, mesh_mode=True)
                elif st.mpix <= thr:
                    key = _bits_hetero_key(st)
                else:
                    key = _bits_group_key(st)
                if key is None:    # multi-scan or partial: decode singly
                    flush("bits")
                    outputs.append(self.decode_one(st))
                    continue
                if groups["bits"] and (key != bits_key[0]
                                       or len(groups["bits"]) >= batch_size):
                    flush("bits")
                bits_key[0] = key
                groups["bits"].append(st)
                continue
            flush("bits")
            pre = groups["prefix"]
            if pre and (st.geometry != pre[0].geometry
                        or len(pre) >= batch_size):
                flush("prefix")
            groups["prefix"].append(st)
        flush("prefix", "bits", "lossless")
        return outputs

    def device_resident_rate(self, source, iters: int = 64, scale_to=None,
                             reps: int = 3, batch: int = 1) -> dict:
        """Device time per image of the full device half (for bits: K1,
        assembly, the IDCT of the decoder's precision and the tail of its
        layout; for prefix: the store rebuild and the same reconstruction;
        for lossless: the predictors) over a wire already in device
        memory, staged by the decoder's interchange, timed with CUDA events
        around `iters` back-to-back decodes; best of `reps`. With batch > 1
        the wire holds `batch` copies merged into one group dispatch (the
        reference's `device_resident_rate(batch=...)`, `stream.py:1497`)
        and the time is per image; an image that cannot group (a bits
        image with no group key, or a merge that declines) is timed alone
        and reported with "batch": 1. Every interchange runs by graph
        replay (`models/graphs.py`): the key's first call, off any graph,
        and the capture come before the timing.
        "host_ms_per_image" is the host's time to enqueue the calls (from
        the first call to the return of the last, before the wait for the
        card), of the same best rep.
        Needs a CUDA device: a measurement finds no card, it fails."""
        if self.device.type != "cuda":
            raise RuntimeError("device_resident_rate measures a CUDA device; "
                               f"this decoder runs on {self.device}")
        staged = self.stage(source, scale_to)
        kind = _kind(staged)
        group = [staged] * batch

        def land():
            """(images, run): the wire landed once, a call on it."""
            wires = None
            if batch > 1 and (kind != "bits" or _bits_group_key(staged)):
                wires = self._group_wires(kind, group)
            if wires is None:
                one = self._to_device(staged)
                return 1, lambda: self._run_device(staged, one)
            return batch, lambda: self._run_group(kind, group, wires)
        land()[1]()             # the key's first call: off any graph
        batch, run = land()     # the key's graph
        run()                   # its capture
        torch.cuda.synchronize(self.device)
        best = float("inf")
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(iters):
                run()
            host = (time.perf_counter() - t0) / iters / batch
            stop.record()
            stop.synchronize()
            ms = start.elapsed_time(stop) / iters / batch
            if ms < best:
                best, best_host = ms, host * 1e3
        return {"ms_per_image": best, "mpix_s": staged.mpix / (best * 1e-3),
                "host_ms_per_image": best_host, "mpix": staged.mpix,
                "interchange": kind, "batch": batch,
                "layout": None if kind == "lossless"
                else self._effective_layout(staged.geometry),
                "precision": self.precision,
                "device": torch.cuda.get_device_name(self.device)}

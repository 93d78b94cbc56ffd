"""Decode-to-device streaming on PyTorch: the one-image stream decoder.

Port of `jpeg_decoder_tpu/models/stream.py`'s `DeviceStreamDecoder`, one
image at a time, in both interchanges, both precisions and the three
layouts. Images come back as tensors on the decoder's device; the host
never reads pixels back:
- "interleaved": [H, W, C] (or [H, W] for grayscale);
- "planar": [C, H, W], the interleaved result permuted (2-D outputs as
  they are);
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

Device stage (per image, on the caller's thread, asynchronous on the
current CUDA stream):
- bits: delta unpack (delta wire), kernel K1 (chunk Huffman decode),
  assembly (DC prefix sums, raster placement), then reconstruction: the
  exact int32 IDCT or kernel K2 by precision, then upsampling and color,
  or K2 and kernel K3 on "planar-pallas";
- prefix: the zigzag prefix and residuals rebuilt into stores, then the
  same reconstruction;
- lossless: the predictor closed forms or kernel L1, then the interleave.

Not ported yet: batch_size > 1 (merged multi-image sweeps).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import time
from typing import Iterable

import numpy as np
import torch

from ..entropy.assemble import GeneralMaps, assemble_nat
from ..entropy.chunk_decode import decode_chunks, unpack_delta
from ..host.decoder import Decoder
from ..host.entropy.prescan import AnchoredScan, PrescanFallback
from ..host.entropy.transcode import transcode_decoded
from ..host.entropy.wire import WORDS_PAD, pack_delta
from ..host.errors import FormatError, JpegError
from ..host.ops.pipeline import ImageGeometry, geometry_from_frame
from ..host.ops.tail import is_420_ycbcr
from ..host.parser import CodingProcess, Predictor
from ..host.staging import (_ZIGZAG_OF_NATURAL, PREFIX_K, BitstreamCapture,
                            StagedImage, StagedLossless, _LosslessCapture,
                            _staged_lossless_from_capture, stage_host)
from ..ops.pipeline import reconstruct, reconstruct_planar_pallas
from ..ops.predictors import reconstruct_planes
from ..params import DeviceParams

LAYOUTS = ("interleaved", "planar", "planar-pallas")
PRECISIONS = ("fast", "exact")
INTERCHANGES = ("bits", "prefix")


@dataclasses.dataclass
class StagedScan:
    """One scan on its wire: the 4 B/chunk delta wire (`ab` and `base`
    None: the device rebuilds them from `dm`), or the 12 B/chunk anchor
    wire (`dm` holds `budget << 4 | slot`, `ab` and `base` ride beside)."""
    scan: AnchoredScan   # the host prescan's staging: plan, tables, n_blocks
    kept: tuple          # ((scan component position, frame component), ...)
    words: np.ndarray    # int32 stream words, zero-padded
    dm: np.ndarray       # int32 per-chunk wire words
    s_max: int           # symbol steps that bound every chunk
    ab: np.ndarray = None     # int32 [n] entry bits (uint32 patterns)
    base: np.ndarray = None   # int32 [n] first stream block of each chunk

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
    budget = scan.anchor_block[1:n + 1].astype(np.int64) \
        - scan.anchor_block[:n]
    slot = scan.anchor_slot[:n].astype(np.int64)
    if n and (budget.min() < 0 or budget.max() > 31 or slot.min() < 0
              or slot.max() > 15):
        raise FormatError("chunk budget or slot outside the anchor wire's "
                          "fields")
    if scan.chunk_syms is not None and n:
        s_max = int(scan.chunk_syms[:n].max())
    else:
        s_max = scan.plan.s_max
    return StagedScan(
        scan, kept,
        words=np.ascontiguousarray(scan.words[:max(scan.n_words, 1)],
                                   np.uint32).view(np.int32),
        dm=(budget << 4 | slot).astype(np.int32),
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
    (words, dm, _cnts), shapes = packed
    if len(words) < scan.n_words + WORDS_PAD:
        raise FormatError("delta wire without its zero word padding")
    return StagedScan(scan, kept, words, dm,
                      max(s_max for (_sw, s_max, _nb, _ni) in shapes))


def _port_bits(st) -> StagedBits:
    """The host copy's StagedBits (from `transcode_decoded`) on the port's
    wires."""
    return StagedBits(st.geometry,
                      tuple(_wire_scan(s, kept) for s, kept in st.scans),
                      st.qts, st.mpix)


def _stage_host_decoded_bits(source, scale_to, precision: str,
                             pool_width: int):
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
                    pool_width: int = 1):
    """Stage one JPEG (bytes, path or file-like) for the device: a
    StagedBits, or a StagedLossless (SOF3), or a StagedImage (the prefix
    interchange) for what the bits wire cannot carry."""
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


def prefix_stores(geometry, dc, ac, resid_idx, resid_vals) -> list:
    """The reference's `_compiled_prefix_pipeline` up to the stores: int16
    dc [N] and int8 ac [N, 15] (zigzag slots 1..15) -> a zigzag [N, 64]
    int16 tensor, permuted to natural order, plus the residuals
    scatter-added (wrapping in int16). Residual indices outside the stores
    (the bucket padding, `total`) are dropped, as `mode="drop"` does, by
    sending them to a sink element past the end. Returns one int16
    [blocks, 64] store per component."""
    n = dc.shape[0]
    padded = torch.cat([dc[:, None], ac.to(torch.int16),
                        dc.new_zeros((n, 64 - PREFIX_K))], dim=1)
    perm = torch.as_tensor(_ZIGZAG_OF_NATURAL, dtype=torch.int64,
                           device=dc.device)
    total = n * 64
    dense = torch.cat([padded[:, perm].reshape(-1), dc.new_zeros(1)])
    idx = resid_idx.to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < total), idx, total)
    dense.index_add_(0, idx, resid_vals)
    sizes = [c.blocks_high * c.blocks_wide * 64 for c in geometry.components]
    return [s.view(-1, 64) for s in dense[:total].split(sizes)]


def lossless_image(st: StagedLossless, diffs: torch.Tensor) -> torch.Tensor:
    """The reference's `_compiled_lossless_pipeline` (batch None): `diffs`
    holds the staged uint16 planes as int16 bit patterns, [C, H, W]. All
    components through `reconstruct_planes` (kernel L1 once per image where
    the predictor needs it), then the element-count-bound interleave;
    uint8 out at precision 8, else uint16."""
    d = diffs.to(torch.int32) & 0xFFFF
    ncomp = d.shape[0]
    planes = reconstruct_planes(d, Predictor(st.predictor),
                                st.point_transform, st.precision,
                                st.restart_all)
    if ncomp == 1:
        img = planes[0]
    else:
        count = st.out_width * st.out_height
        img = torch.stack([p.reshape(-1)[:count] for p in planes],
                          dim=-1).reshape(st.out_height, st.out_width, ncomp)
    return img.to(torch.uint8 if st.precision == 8 else torch.uint16)


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
    kernels do. Asking for CUDA where there is no card raises."""

    def __init__(self, *, device="cuda", host_threads: int = 4,
                 precision: str = "fast", layout: str = "interleaved",
                 interchange: str = "bits"):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               "torch.cuda.is_available() is False")
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device!r}")
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
        self.params = DeviceParams(dev)
        self._maps: dict = {}
        self.pool = cf.ThreadPoolExecutor(max_workers=host_threads)

    def close(self) -> None:
        self.pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stage(self, source, scale_to=None):
        """Host stage of one image, by the decoder's interchange."""
        if self.interchange == "bits":
            return stage_host_bits(source, scale_to, self.precision,
                                   self.host_threads)
        return stage_host(source, scale_to, self.precision,
                          pool_width=self.host_threads)

    def _to_device(self, staged) -> tuple:
        """H2D copies of the staged wire."""
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        kind = _kind(staged)
        if kind == "bits":
            return tuple((put(s.words), put(s.dm)) if s.ab is None
                         else (put(s.words), put(s.dm), put(s.ab),
                               put(s.base))
                         for s in staged.scans)
        if kind == "lossless":
            return (put(staged.diffs.view(np.int16)),)
        return tuple(put(a) for a in (staged.dc, staged.ac, staged.resid_idx,
                                      staged.resid_vals))

    def _general_maps(self, plan):
        maps = self._maps.get(plan)
        if maps is None:
            if len(self._maps) > 64:
                self._maps.clear()
            maps = self._maps[plan] = GeneralMaps(plan, self.device)
        return maps

    def _effective_layout(self, geometry) -> str:
        """planar-pallas downgrades to plain planar for geometries the fused
        tail doesn't cover: one rule for every dispatch shape."""
        if self.layout == "planar-pallas" and not is_420_ycbcr(geometry):
            return "planar"
        return self.layout

    def _reconstruct(self, geometry, stores, qts) -> torch.Tensor:
        layout = self._effective_layout(geometry)
        with torch.profiler.record_function("reconstruct"):  # K3: fused_tail
            if layout == "planar-pallas":
                return reconstruct_planar_pallas(geometry, stores, qts,
                                                 self.params)
            out = reconstruct(geometry, stores, qts, self.params)
            if layout == "planar" and out.dim() == 3:
                return out.permute(2, 0, 1).contiguous()
            return out

    def _bits_stores(self, staged: StagedBits, wires: tuple) -> list:
        span = torch.profiler.record_function   # layer names in traces
        stores = [None] * len(staged.qts)
        for st, wire in zip(staged.scans, wires):
            plan = st.scan.plan
            if st.ab is None:
                words, dm = wire
                with span("unpack_delta"):
                    ab, _budget, _slot0, base = unpack_delta(dm)
            else:
                words, dm, ab, base = wire
            with span("k1_decode"):
                nat = decode_chunks(words, dm, ab, base,
                                    self.params.tables(st.scan), st.s_max,
                                    plan.n_blocks)
            with span("assemble"):
                maps = None if plan.structured is not None \
                    else self._general_maps(plan)
                scan_stores = assemble_nat(nat, plan, maps)
            for pos, comp_i in st.kept:
                stores[comp_i] = scan_stores[pos]
        return stores

    def _run_device(self, staged, wires: tuple) -> torch.Tensor:
        """The device half for one image whose wire is already on the
        device. Enqueues work only: no host synchronisation."""
        kind = _kind(staged)
        if kind == "lossless":
            with torch.profiler.record_function("lossless"):
                return lossless_image(staged, wires[0])
        if kind == "bits":
            stores = self._bits_stores(staged, wires)
        else:
            with torch.profiler.record_function("prefix_stores"):
                stores = prefix_stores(staged.geometry, *wires)
        return self._reconstruct(staged.geometry, stores, staged.qts)

    def decode_one(self, staged) -> torch.Tensor:
        """Decode one staged image (bits, prefix or lossless)."""
        return self._run_device(staged, self._to_device(staged))

    def decode_stream(self, sources: Iterable, scale_to=None,
                      batch_size: int = 1, on_error: str = "raise") -> list:
        """Decode all sources, in order, to device tensors. The pool stages
        later images on the host while earlier ones decode on the device.

        on_error: "raise" propagates the first failure; any other value
        ("none") isolates a source whose staging raises a JpegError: its
        slot holds None and later sources still decode, as in the
        reference."""
        if batch_size != 1:
            # When batching lands, a None slot must first flush every open
            # group, as the reference does (jpeg_decoder_tpu/models/
            # stream.py:1647-1654), so outputs stay in source order.
            raise NotImplementedError(
                "batch_size > 1 (merged multi-image sweeps) is not ported yet")
        futures = [self.pool.submit(self.stage, s, scale_to) for s in sources]

        def resolve(fut):
            if on_error == "raise":
                return fut.result()
            try:
                return fut.result()
            except JpegError:
                return None

        try:
            return [None if st is None else self.decode_one(st)
                    for st in map(resolve, futures)]
        except BaseException:
            for f in futures:      # stop staging what will not be decoded
                f.cancel()
            raise

    def device_resident_rate(self, source, iters: int = 64, scale_to=None,
                             reps: int = 3) -> dict:
        """Device time per image of the full device half (for bits: K1,
        assembly, the IDCT of the decoder's precision and the tail of its
        layout; for prefix: the store rebuild and the same reconstruction;
        for lossless: the predictors) over a wire already in device
        memory, staged by the decoder's interchange, timed with CUDA events
        around `iters` back-to-back decodes; best of `reps`.
        Needs a CUDA device: a measurement finds no card, it fails."""
        if self.device.type != "cuda":
            raise RuntimeError("device_resident_rate measures a CUDA device; "
                               f"this decoder runs on {self.device}")
        staged = self.stage(source, scale_to)
        wires = self._to_device(staged)
        self._run_device(staged, wires)                    # warm-up
        torch.cuda.synchronize(self.device)
        best = float("inf")
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(iters):
                self._run_device(staged, wires)
            stop.record()
            stop.synchronize()
            host = (time.perf_counter() - t0) / iters
            ms = start.elapsed_time(stop) / iters
            if ms < best:
                best, best_host = ms, host * 1e3
        kind = _kind(staged)
        return {"ms_per_image": best, "mpix_s": staged.mpix / (best * 1e-3),
                "host_ms_per_image": best_host, "mpix": staged.mpix,
                "interchange": kind, "batch": 1,
                "layout": None if kind == "lossless"
                else self._effective_layout(staged.geometry),
                "precision": self.precision,
                "device": torch.cuda.get_device_name(self.device)}

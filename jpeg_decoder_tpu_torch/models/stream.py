"""Decode-to-device streaming on PyTorch: the bits interchange main path.

Port of `jpeg_decoder_tpu/models/stream.py`'s bits path
(`DeviceStreamDecoder(interchange="bits")` with the delta wire and
precision "fast") in its three layouts. Images come back as uint8 tensors
on the decoder's device; the host never reads pixels back:
- "interleaved": [H, W, C] (or [H, W] for grayscale);
- "planar": [C, H, W], the interleaved result permuted (2-D outputs as
  they are);
- "planar-pallas": [C, H, W] through kernel K3 (fused upsample + color)
  for the geometries `pallas_tail_mode` covers, else "planar" (one rule,
  `_effective_layout`, as in the reference).

Host stage (per image, in a thread pool): parse, prescan and
`pack_delta`, all reused by import from the JAX package's numpy/C++ host
code. The reference's own `stage_host_bits` is NOT used: it ends in
`_attach_pallas`, which imports JAX to look for a TPU. `stage_host_bits`
here runs the same Decoder hooks and calls `geometry_from_frame` and
`pack_delta` directly.

Device stage (per image, on the caller's thread, asynchronous on the
current CUDA stream): delta unpack, kernel K1 (chunk Huffman decode),
assembly (DC prefix sums, raster placement), kernel K2 (dequant + IDCT),
then upsampling and color, or kernel K3 on "planar-pallas".

Not ported yet, and raising rather than restaging: progressive JPEG (the
reference transcodes it into the bits wire), lossless (SOF3), streams the
prescan sends to the host engines (`PrescanFallback`), scans `pack_delta`
declines (the words-packed wire), batch_size > 1, precision "exact" and
the prefix interchange.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import time
from typing import Iterable

import numpy as np
import torch

from jpeg_decoder_tpu.decoder import Decoder
from jpeg_decoder_tpu.entropy.device_scan import AnchoredScan, PrescanFallback
from jpeg_decoder_tpu.entropy.pallas_decode import WORDS_PAD, pack_delta
from jpeg_decoder_tpu.errors import FormatError
from jpeg_decoder_tpu.models.stream import BitstreamCapture
from jpeg_decoder_tpu.ops.pallas_kernels import is_420_ycbcr
from jpeg_decoder_tpu.ops.pipeline import ImageGeometry, geometry_from_frame
from jpeg_decoder_tpu.parser import CodingProcess

from ..entropy.assemble import GeneralMaps, assemble_nat
from ..entropy.chunk_decode import decode_chunks, unpack_delta
from ..ops.pipeline import reconstruct, reconstruct_planar_pallas
from ..params import DeviceParams

LAYOUTS = ("interleaved", "planar", "planar-pallas")


@dataclasses.dataclass
class StagedScan:
    """One baseline scan on the 4 B/chunk delta wire."""
    scan: AnchoredScan   # the reference's staging: plan, tables, n_blocks
    kept: tuple          # ((scan component position, frame component), ...)
    words: np.ndarray    # int32 [n_wpad] stream words, zero-padded
    dm: np.ndarray       # int32 [n_pad] per-chunk wire words + terminator
    cnts: np.ndarray     # int32 [n_classes] live chunks per class
    s_max: int           # symbol steps that bound every chunk


@dataclasses.dataclass
class StagedBits:
    """One image staged for the device: its scans plus reconstruction
    geometry and quantization tables."""
    geometry: ImageGeometry
    scans: tuple         # (StagedScan, ...)
    qts: tuple           # uint16[64] natural order, per frame component
    mpix: float


def _wire_scan(scan: AnchoredScan, kept: tuple) -> StagedScan:
    packed = pack_delta(scan)
    if packed is None:
        raise NotImplementedError(
            "pack_delta declined this scan (field overflow, span over 512 B, "
            "more than 4 tables or over 224 symbols per chunk); the "
            "words-packed wire and the XLA-engine inputs are not ported yet")
    (words, dm, cnts), shapes = packed
    if len(words) < scan.n_words + WORDS_PAD:
        raise FormatError("delta wire without its zero word padding")
    return StagedScan(scan, kept, words, dm, cnts,
                      max(s_max for (_sw, s_max, _nb, _ni) in shapes))


def stage_host_bits(source, scale_to=None,
                    precision: str = "fast") -> StagedBits:
    """Parse + prescan + pack one baseline JPEG (bytes, path or file-like)
    into the delta wire. Raises NotImplementedError, naming the missing
    piece, for streams outside the ported slice."""
    d = Decoder(source, backend="numpy")
    d.read_info()
    process = d.frame.coding_process
    if process == CodingProcess.DCT_PROGRESSIVE:
        raise NotImplementedError(
            "progressive JPEG: the host-decode + transcode staging "
            "(entropy/transcode.py) is not ported yet")
    if process == CodingProcess.LOSSLESS:
        raise NotImplementedError(
            "lossless (SOF3) JPEG: device predictor reconstruction is not "
            "ported yet")
    capture = BitstreamCapture()
    d._prefix_capture = capture
    if scale_to is not None:
        d.scale(*scale_to)
    try:
        d._decode_entropy_only()
    except PrescanFallback as e:
        raise NotImplementedError(
            f"stream needs host entropy semantics ({e}); the host-decode + "
            f"transcode path is not ported yet") from e

    frame = d.frame
    n = len(frame.components)
    if not capture.used or any(i not in d._pending_render for i in range(n)):
        raise FormatError("not all components have data")
    transform = None if n == 1 else d._determine_color_transform()
    geometry = geometry_from_frame(frame, transform, precision=precision)
    qts = tuple(d._pending_render[i][1] for i in range(n))
    info = d.info()
    return StagedBits(geometry,
                      tuple(_wire_scan(s, kept) for s, kept in capture.scans),
                      qts, info.width * info.height / 1e6)


class DeviceStreamDecoder:
    """Streaming decode to tensors on `device` ("cuda", "cuda:N" or "cpu").
    On the CPU the kernels' plain PyTorch versions run; on a CUDA device
    the hand-written kernels do."""

    def __init__(self, *, device, host_threads: int = 4,
                 precision: str = "fast", layout: str = "interleaved",
                 interchange: str = "bits"):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               "torch.cuda.is_available() is False")
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device!r}")
        if precision != "fast":
            raise NotImplementedError(
                f"precision {precision!r}: only 'fast' is ported yet")
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")
        if interchange != "bits":
            raise NotImplementedError(
                f"interchange {interchange!r}: only 'bits' is ported yet")
        self.device = dev
        self.precision = precision
        self.layout = layout
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

    def stage(self, source, scale_to=None) -> StagedBits:
        return stage_host_bits(source, scale_to, self.precision)

    def _to_device(self, staged: StagedBits) -> tuple:
        """H2D copies of every scan's (words, dm)."""
        return tuple((torch.from_numpy(s.words).to(self.device),
                      torch.from_numpy(s.dm).to(self.device))
                     for s in staged.scans)

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

    def _run_device(self, staged: StagedBits, wires: tuple) -> torch.Tensor:
        """The device half for one image whose wire is already on the
        device. Enqueues work only: no host synchronisation."""
        span = torch.profiler.record_function   # layer names in traces
        ncomp = len(staged.qts)
        stores = [None] * ncomp
        for st, (words, dm) in zip(staged.scans, wires):
            plan = st.scan.plan
            with span("unpack_delta"):
                ab, _budget, _slot0, base = unpack_delta(dm)
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
        layout = self._effective_layout(staged.geometry)
        with span("reconstruct"):     # K3 inside, under span "fused_tail"
            if layout == "planar-pallas":
                return reconstruct_planar_pallas(staged.geometry, stores,
                                                 staged.qts, self.params)
            out = reconstruct(staged.geometry, stores, staged.qts,
                              self.params)
            if layout == "planar" and out.dim() == 3:
                return out.permute(2, 0, 1).contiguous()
            return out

    def decode_one(self, staged: StagedBits) -> torch.Tensor:
        return self._run_device(staged, self._to_device(staged))

    def decode_stream(self, sources: Iterable, scale_to=None,
                      batch_size: int = 1) -> list:
        """Decode all sources, in order, to device tensors. The pool stages
        later images on the host while earlier ones decode on the device."""
        if batch_size != 1:
            raise NotImplementedError(
                "batch_size > 1 (merged multi-image sweeps) is not ported yet")
        futures = [self.pool.submit(self.stage, s, scale_to) for s in sources]
        try:
            return [self.decode_one(f.result()) for f in futures]
        except BaseException:
            for f in futures:      # stop staging what will not be decoded
                f.cancel()
            raise

    def device_resident_rate(self, source, iters: int = 64, scale_to=None,
                             reps: int = 3) -> dict:
        """Device time per image of the full device half (K1, assembly, K2,
        the tail of the decoder's layout) over a wire already in device
        memory, timed with CUDA events around `iters` back-to-back decodes;
        best of `reps`.
        Needs a CUDA device: a measurement finds no card, it fails."""
        if self.device.type != "cuda":
            raise RuntimeError("device_resident_rate measures a CUDA device; "
                               f"this decoder runs on {self.device}")
        staged = stage_host_bits(source, scale_to, self.precision)
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
        return {"ms_per_image": best, "mpix_s": staged.mpix / (best * 1e-3),
                "host_ms_per_image": best_host, "mpix": staged.mpix,
                "interchange": "bits", "batch": 1,
                "layout": self._effective_layout(staged.geometry),
                "device": torch.cuda.get_device_name(self.device)}

"""Copy of the host stage of `jpeg_decoder_tpu/models/stream.py` at
commit 0c2d0ea: the constants and `_bucket` (`:36-72`), `StagedImage`
(`:214`), `_BufferPool` (`:225-271`), `PrefixCapture` and `stage_host`
(`:274-570`), `StagedBits` and `BitstreamCapture` (`:570-615`) and the
lossless staging (`:673-760`).

Left out: the reference's `stage_host_bits` (the port's
`models/stream.py` routes a stream itself) and everything that runs on
JAX. The device stage is the port's.

Per image the host runs the bit-serial entropy stage and either keeps the
entropy-coded words for the device's Huffman decode (`BitstreamCapture`,
the bits interchange), or ships coefficients in the zigzag-prefix format
(`stage_host`, the prefix interchange): a dense int16 [blocks, K] tensor
of each block's first K zigzag coefficients plus a small COO residual for
nonzeros beyond the prefix. Lossless frames ship their difference planes
(`StagedLossless`).
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from .decoder import Decoder
from .entropy.scan_python import UNZIGZAG
from .ops.pipeline import ImageGeometry, geometry_from_frame
from .parser import CodingProcess

PREFIX_K = 16


def _tune_malloc() -> None:
    """Keep multi-MB numpy buffers on the heap instead of per-allocation mmap.

    glibc mmaps allocations above ~128KB and munmaps them on free, so every
    per-image tensor (prefix, residuals) pays full page-fault cost again —
    measured at 100+ ms per large_image-class decode. Raising the mmap
    threshold (and disabling trim) makes the heap retain and reuse the pages.
    """
    import ctypes
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except Exception:
        pass


_tune_malloc()

# Natural index -> zigzag position (inverse of UNZIGZAG).
_ZIGZAG_OF_NATURAL = np.zeros(64, np.int32)
for _z, _n in enumerate(UNZIGZAG):
    _ZIGZAG_OF_NATURAL[_n] = _z


def _bucket(n: int, floor: int = 2048) -> int:
    """Round up to a compile-friendly bucket (1.3x geometric steps)."""
    size = floor
    while size < n:
        size = int(size * 1.3) + (-int(size * 1.3) % 256)
    return size


def _anchored_enabled() -> bool:
    """Host-parallel anchored entropy decode for non-DRI baseline scans
    (entropy.cc jt_decode_scan_dct_prefix_anchored): prescan walk + N-thread
    re-decode from MCU-aligned anchors. Round 2 gated this to >=6 cores
    (the prescan walk alone cost ~0.8x a serial decode); the round-3
    speculative prescan split changed the economics — re-measured 1.64x on
    THIS 4-core host (tools/experiments/anchored4_ab.py: 11.7 -> 7.1 ms
    serial prefix staging), so default-on at >=4 cores now.
    JPEG_TPU_ANCHORED=1 forces it on (0 off) regardless."""
    import os
    v = os.environ.get("JPEG_TPU_ANCHORED")
    if v is not None:
        return v not in ("0", "", "off")
    return (os.cpu_count() or 1) >= 4


@dataclasses.dataclass
class StagedImage:
    geometry: ImageGeometry
    dc: np.ndarray          # int16 [sum_blocks]
    ac: np.ndarray          # int8 [sum_blocks, K-1], saturated zigzag slots
    resid_idx: np.ndarray   # int32 [resid_bucket]; padding -> out of range (dropped)
    resid_vals: np.ndarray  # int16 [resid_bucket]
    qts: tuple
    total_coeffs: int
    mpix: float


class _BufferPool:
    """Reusable host buffers keyed by (dtype, size). Large per-image numpy
    allocations hit mmap/page-fault churn (~100s of ms for 20MB-class
    tensors); pooling keeps the pages resident across images.

    Bounded: at most `depth` buffers per (dtype, size) and `budget` total
    bytes — a long-lived service decoding diverse image sizes must not grow
    without limit. Eviction drops the least-recently-released size class."""

    def __init__(self, depth: int = 8, budget: int = 1 << 30):
        self._lock = threading.Lock()
        self._free: dict = {}
        self._depth = depth
        self._budget = budget
        self._bytes = 0

    def acquire(self, size: int, dtype) -> np.ndarray:
        key = (np.dtype(dtype).str, size)
        with self._lock:
            stack = self._free.get(key)
            if stack:
                arr = stack.pop()
                self._bytes -= arr.nbytes
                return arr
        return np.empty(size, dtype=dtype)

    def release(self, arr: np.ndarray) -> None:
        key = (arr.dtype.str, arr.size)
        with self._lock:
            stack = self._free.setdefault(key, [])
            if len(stack) >= self._depth:
                return  # drop: per-class cap
            stack.append(arr)
            self._free[key] = stack
            # Move to MRU position for budget eviction order.
            self._free.pop(key)
            self._free[key] = stack
            self._bytes += arr.nbytes
            while self._bytes > self._budget and len(self._free) > 1:
                old_key = next(iter(self._free))
                if old_key == key:
                    break
                for dropped in self._free.pop(old_key):
                    self._bytes -= dropped.nbytes


_pool = _BufferPool()


class PrefixCapture:
    """Receives baseline scan output in the device interchange format straight
    from the native entropy kernel — no dense 64-coefficient stores ever exist
    on the host, roughly quartering per-image host memory traffic (the staging
    stage is DRAM-bandwidth-bound at multi-worker rates)."""

    def __init__(self, native, k: int = PREFIX_K, pool_width: int = 1):
        self.native = native
        self.k = k
        self.pool_width = max(1, pool_width)
        self.prefix_arrays: dict = {}   # frame comp index -> int16 [nblocks, K]
        self.bases: list = []
        self.sizes: list = []
        self.total = 0
        self.resid_idx = None
        self.resid_vals = None
        self.resid_count = 0
        self.used = False

    def wants(self, frame) -> bool:
        return True

    def _ensure_layout(self, frame) -> None:
        if self.bases:
            return
        self.sizes = [c.block_size.width * c.block_size.height * 64
                      for c in frame.components]
        self.bases = list(np.cumsum([0] + self.sizes)[:-1])
        self.total = int(sum(self.sizes))
        self.resid_idx = _pool.acquire(self.total, np.int32)
        self.resid_vals = _pool.acquire(self.total, np.int16)

    def _prefix_for(self, comp_i: int, frame):
        pair = self.prefix_arrays.get(comp_i)
        if pair is None:
            nblocks = self.sizes[comp_i] // 64
            dc = _pool.acquire(nblocks, np.int16)
            ac_flat = _pool.acquire(nblocks * (self.k - 1), np.int8)
            self.native.zero_buffer(dc)
            self.native.zero_buffer(ac_flat)
            pair = (dc, ac_flat.reshape(nblocks, self.k - 1))
            self.prefix_arrays[comp_i] = pair
        return pair

    def decode_scan(self, decoder, frame, scan, finished):
        self._ensure_layout(frame)
        self.used = True
        dcs, acs, bases = [], [], []
        for pos, comp_i in enumerate(scan.component_indices):
            if finished[pos]:
                dc, ac = self._prefix_for(comp_i, frame)
                dcs.append(dc)
                acs.append(ac)
                qt = decoder._quantization_tables[
                    frame.components[comp_i].quantization_table_index]
                decoder._pending_render[comp_i] = (None, qt.copy())
            else:
                dcs.append(None)  # dummy-block case
                acs.append(None)
            bases.append(self.bases[comp_i])

        anchored = self._try_anchored(decoder, frame, scan, dcs, acs, bases)
        if anchored is not None:
            return anchored[0]

        marker, self.resid_count = self.native.decode_scan_dct_prefix(
            decoder._cursor, frame, scan,
            decoder._dc_huffman_tables, decoder._ac_huffman_tables,
            decoder._restart_interval, dcs, acs, bases, self.k,
            self.resid_idx, self.resid_vals, self.resid_count)
        return marker

    def _try_anchored(self, decoder, frame, scan, dcs, acs, bases):
        """Prescan + multi-thread anchored decode of one baseline scan.
        Returns (marker,) on success (cursor already past the scan) or None
        to run the serial path — on kernel fallback the cursor is restored
        and the prefix outputs are re-zeroed by the kernel itself."""
        import os

        from .parser import CodingProcess
        if not _anchored_enabled():
            return None
        if frame.coding_process == CodingProcess.DCT_PROGRESSIVE:
            return None
        if (decoder._restart_interval > 0
                or scan.spectral_selection_start != 0
                or scan.spectral_selection_end != 64
                or scan.successive_approximation_high != 0
                or scan.successive_approximation_low != 0):
            return None
        if not hasattr(self.native, "decode_scan_dct_prefix_anchored"):
            return None

        from .entropy.prescan import (K_CAP, S_MAX, S_TARGET,
                                           _prescan_geometry,
                                           scan_decode_luts)
        geometry = _prescan_geometry(frame, scan, 0)
        # Cores available to THIS image's intra-image threads: siblings in
        # the staging pool already decode other images concurrently, and
        # oversubscribing on top measurably loses (pooled 5-worker burst
        # 678 -> 464 Mpix/s with anchored forced on, 4 cores).
        nt = min((os.cpu_count() or 1) // self.pool_width, 8)
        n_mcus = geometry["est_blocks"] // len(geometry["pattern"])
        if nt < 2 or n_mcus < 8 * nt:
            return None

        luts = scan_decode_luts(scan, decoder._dc_huffman_tables,
                                decoder._ac_huffman_tables)
        if luts is None:
            return None

        cursor = decoder._cursor
        pos0 = cursor.pos
        res = self.native.prescan_baseline(cursor, luts, geometry,
                                           S_TARGET, K_CAP, S_MAX)
        if res is None:
            cursor.pos = pos0
            return None
        out_bytes, a_bits, a_block, a_slot, _n_blocks, pending, _, _ = res
        count = self.native.decode_scan_dct_prefix_anchored(
            cursor, frame, scan, decoder._dc_huffman_tables,
            decoder._ac_huffman_tables, dcs, acs, bases, self.k,
            self.resid_idx, self.resid_vals, self.resid_count,
            out_bytes, a_bits, a_block, a_slot)
        if count is None:
            cursor.pos = pos0
            return None
        self.resid_count = count
        return (pending,)

    def release(self) -> None:
        for dc, ac in self.prefix_arrays.values():
            _pool.release(dc)
            _pool.release(ac.reshape(-1))
        if self.resid_idx is not None:
            _pool.release(self.resid_idx)
            _pool.release(self.resid_vals)


def _staged_from_capture(d: Decoder, capture: PrefixCapture, precision: str,
                         pooled: list) -> StagedImage:
    from .errors import FormatError

    frame = d.frame
    n = len(frame.components)
    if any(i not in d._pending_render for i in range(n)):
        capture.release()
        for buf in pooled:
            _pool.release(buf)
        raise FormatError("not all components have data")

    transform = None if n == 1 else d._determine_color_transform()
    geometry = geometry_from_frame(frame, transform, precision=precision)
    qts = tuple(d._pending_render[i][1] for i in range(n))

    total_blocks = capture.total // 64
    dc = np.empty(total_blocks, np.int16)
    ac = np.empty((total_blocks, capture.k - 1), np.int8)
    row = 0
    for i in range(n):
        nblocks = capture.sizes[i] // 64
        pair = capture.prefix_arrays.get(i)
        if pair is None:
            dc[row:row + nblocks] = 0
            ac[row:row + nblocks] = 0
        else:
            dc[row:row + nblocks] = pair[0]
            ac[row:row + nblocks] = pair[1]
        row += nblocks

    r = capture.resid_count
    bucket = _bucket(r)
    resid_idx = np.full(bucket, capture.total, np.int32)
    resid_vals = np.zeros(bucket, np.int16)
    resid_idx[:r] = capture.resid_idx[:r]
    resid_vals[:r] = capture.resid_vals[:r]

    capture.release()
    for buf in pooled:
        _pool.release(buf)

    info = d.info()
    return StagedImage(geometry, dc, ac, resid_idx, resid_vals, qts,
                       capture.total, info.width * info.height / 1e6)


def stage_host(source, scale_to=None, precision: str = "fast",
               timer=None, pool_width: int = 1) -> StagedImage:
    """Host stages for one image: parse + entropy + prefix/residual pack.

    `timer` (a `utils.timing.StageTimer`) records this as the "host_stage"
    stage — the per-stage observability layer the reference lacks
    (SURVEY.md §5). `pool_width` tells the anchored intra-image threads how
    many sibling staging workers share the cores (see _try_anchored)."""
    if timer is not None:
        with timer.stage("host_stage"):
            return stage_host(source, scale_to, precision, None, pool_width)
    from .entropy.native import get_native
    native = get_native()

    d = Decoder(source, backend="numpy")
    pooled: list = []
    capture = None
    if native is not None:
        def alloc(size: int) -> np.ndarray:
            buf = _pool.acquire(size, np.int16)
            native.zero_buffer(buf)
            pooled.append(buf)
            return buf
        d._store_allocator = alloc
        capture = PrefixCapture(native, pool_width=pool_width)
        d._prefix_capture = capture
    ll_cap = _LosslessCapture()
    d._lossless_capture = ll_cap

    if scale_to is not None:
        d.scale(*scale_to)
    d._decode_entropy_only()

    if ll_cap.scans:
        for buf in pooled:
            _pool.release(buf)
        return _staged_lossless_from_capture(d, ll_cap)
    if capture is not None and capture.used:
        return _staged_from_capture(d, capture, precision, pooled)

    n_comp = len(d.frame.components) if d.frame is not None else 0
    if n_comp == 0 or any(i not in d._pending_render for i in range(n_comp)):
        for buf in pooled:
            _pool.release(buf)
        from .errors import FormatError
        raise FormatError("not all components have data")
    n = len(d.frame.components)
    stores = [d._pending_render[i][0].reshape(-1) for i in range(n)]
    qts = tuple(d._pending_render[i][1] for i in range(n))
    transform = None if n == 1 else d._determine_color_transform()
    geometry = geometry_from_frame(d.frame, transform, precision=precision)

    nblocks = [s.size // 64 for s in stores]
    total_blocks = sum(nblocks)
    total = total_blocks * 64

    dc = np.empty(total_blocks, np.int16)
    ac = np.empty((total_blocks, PREFIX_K - 1), np.int8)
    scratch_idx = _pool.acquire(total, np.int32)
    scratch_vals = _pool.acquire(total, np.int16)

    r = 0
    brow = 0
    base = 0
    if native is not None:
        for s, nb in zip(stores, nblocks):
            r += native.pack_prefix(s, nb, PREFIX_K, base,
                                    dc[brow:brow + nb], ac[brow:brow + nb],
                                    scratch_idx[r:], scratch_vals[r:])
            brow += nb
            base += s.size
    else:
        zz = np.asarray(UNZIGZAG)
        for s, nb in zip(stores, nblocks):
            blocks = s.reshape(nb, 64)
            zzb = blocks[:, zz].astype(np.int32)
            dc[brow:brow + nb] = zzb[:, 0].astype(np.int16)
            sat = np.clip(zzb[:, 1:PREFIX_K], -128, 127)
            ac[brow:brow + nb] = sat.astype(np.int8)
            # int8 saturation corrections ride the residual.
            ebi, ezi = np.nonzero(zzb[:, 1:PREFIX_K] != sat)
            cnt = len(ebi)
            scratch_idx[r:r + cnt] = base + ebi * 64 + zz[1 + ezi]
            scratch_vals[r:r + cnt] = (zzb[:, 1:PREFIX_K] - sat)[ebi, ezi]
            r += cnt
            tail = zzb[:, PREFIX_K:]
            bi, zi = np.nonzero(tail)
            cnt = len(bi)
            scratch_idx[r:r + cnt] = base + bi * 64 + zz[PREFIX_K + zi]
            scratch_vals[r:r + cnt] = tail[bi, zi]
            r += cnt
            brow += nb
            base += s.size

    bucket = _bucket(r)
    resid_idx = np.full(bucket, total, np.int32)  # out-of-range: dropped
    resid_vals = np.zeros(bucket, np.int16)
    resid_idx[:r] = scratch_idx[:r]
    resid_vals[:r] = scratch_vals[:r]
    _pool.release(scratch_idx)
    _pool.release(scratch_vals)
    for buf in pooled:
        _pool.release(buf)

    info = d.info()
    return StagedImage(geometry, dc, ac, resid_idx, resid_vals, qts, total,
                       info.width * info.height / 1e6)


@dataclasses.dataclass
class StagedBits:
    """One image staged in the compressed-bits interchange: the entropy-coded
    bytes themselves plus anchors; Huffman decode runs on device
    (the port's kernel K1). ~0.2-0.4 B/px of H2D traffic vs ~0.9 for the
    prefix interchange — the sustained-throughput lever."""
    geometry: ImageGeometry
    scans: tuple      # ((AnchoredScan, kept_comp_indices), ...)
    qts: tuple
    mpix: float


class BitstreamCapture:
    """Decoder hook staging baseline scans as anchored bitstreams. Raises
    PrescanFallback (caught by stage_host) when any scan needs host
    semantics — the whole image then restages through the prefix path."""

    def __init__(self):
        self.scans: list = []
        self.used = False

    def wants(self, frame) -> bool:
        return True

    def decode_scan(self, decoder, frame, scan, finished):
        from .entropy.prescan import prescan_baseline

        marker, staged = prescan_baseline(
            decoder._cursor, frame, scan,
            decoder._dc_huffman_tables, decoder._ac_huffman_tables,
            decoder._restart_interval)
        self.used = True
        kept = []
        for pos, comp_i in enumerate(scan.component_indices):
            if finished[pos]:
                kept.append((pos, comp_i))
                qt = decoder._quantization_tables[
                    frame.components[comp_i].quantization_table_index]
                decoder._pending_render[comp_i] = (None, qt.copy())
        self.scans.append((staged, tuple(kept)))
        return marker


@dataclasses.dataclass
class StagedLossless:
    """Lossless (SOF3) image staged for device reconstruction: the host runs
    only the Huffman difference decode (C++ jt_decode_scan_lossless); the
    predictor recurrences run on device (ops/predictors.py closed forms, or
    the anti-diagonal wavefront for predictors 5-7 / point transforms),
    bit-identical to src/decoder/lossless.rs:108-226.

    The wire is the difference plane reduced mod 2^16 (uint16, 2 B/sample):
    every predictor computes (prediction + diff) & 0xFFFF, so only the
    diff's low 16 bits can reach the output."""
    diffs: np.ndarray       # uint16 [ncomp, H, W]
    predictor: int
    point_transform: int
    precision: int
    restart_all: bool       # the reference's stale phase-2 restart flag
    out_width: int
    out_height: int
    mpix: float

    @property
    def group_key(self) -> tuple:
        return ("lossless", self.diffs.shape, self.predictor,
                self.point_transform, self.precision, self.restart_all,
                self.out_width, self.out_height)


class _LosslessCapture:
    """Decoder hook (decoder.py _process_scan_lossless): captures the decoded
    difference planes instead of reconstructing them on the host."""

    def __init__(self):
        self.scans = []

    def wants(self, frame, scan) -> bool:
        return True

    def capture_scan(self, decoder, frame, scan, diffs, restart_all, marker):
        self.scans.append((frame, scan, diffs, restart_all))
        return marker


def _staged_lossless_from_capture(d: Decoder, cap: _LosslessCapture
                                  ) -> StagedLossless:
    from .errors import FormatError
    from .parser import Predictor

    if len(cap.scans) != 1:
        raise FormatError("multi-scan lossless stays host-side")
    frame, scan, diffs, restart_all = cap.scans[0]
    if len(scan.component_indices) != len(frame.components):
        raise FormatError("partial-component lossless scan stays host-side")
    predictor = scan.predictor_selection
    pt = scan.point_transform
    if predictor == Predictor.RA and pt != 0:
        # The reference's Ra fast path has its own dispatch-order semantics
        # and the pt != 0 windowed chain has no device form — host oracle
        # owns this rare configuration (see decoder._reconstruct_lossless_device).
        raise FormatError("Ra with point transform stays host-side")
    out_w = frame.output_size.width
    out_h = frame.output_size.height
    ncomp = diffs.shape[0]
    if ncomp == 1 and diffs.shape[1:] != (out_h, out_w):
        raise FormatError("scaled single-component lossless stays host-side")
    info = d.info()
    return StagedLossless(
        diffs=(diffs & 0xFFFF).astype(np.uint16),
        predictor=int(predictor), point_transform=pt,
        precision=frame.precision, restart_all=bool(restart_all),
        out_width=out_w, out_height=out_h,
        mpix=info.width * info.height / 1e6)


def stage_host_lossless(source, scale_to=None, precision: str = "fast",
                        timer=None) -> StagedLossless:
    """Host stages for one lossless image: parse + Huffman difference decode.
    Raises a typed FormatError for configurations the device path declines
    (multi-scan, partial-component, Ra with point transform)."""
    from .errors import FormatError

    if timer is not None:
        with timer.stage("host_stage"):
            return stage_host_lossless(source, scale_to, precision, None)
    d = Decoder(source, backend="numpy")
    cap = _LosslessCapture()
    d._lossless_capture = cap
    if scale_to is not None:
        d.scale(*scale_to)
    d._decode_entropy_only()
    if not cap.scans:
        raise FormatError("not a lossless stream")
    return _staged_lossless_from_capture(d, cap)

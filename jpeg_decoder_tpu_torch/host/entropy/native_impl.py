"""Copy of `jpeg_decoder_tpu/entropy/native_impl.py` at commit 0c2d0ea.

ctypes bindings for the C++ host entropy kernel (cpp/entropy.cc).

Builds the shared library on demand with g++ (no pip deps), marshals the
Huffman tables prepared by ..huffman as raw pointers, and exposes the same
decode_scan_* interface as the Python oracle. ctypes releases the GIL for the
duration of each call, so host thread pools scale across cores.
"""

from __future__ import annotations

import ctypes as C
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..errors import FormatError, IoError
from ..parser import CodingProcess

_DIR = os.path.dirname(os.path.abspath(__file__))
_CPP = os.path.join(_DIR, "cpp", "entropy.cc")
# The library builds outside the source tree, into the repository's
# git-ignored build/ directory.
_BUILD_DIR = os.path.join(_DIR, os.pardir, os.pardir, os.pardir, "build",
                          "host")
_SO = os.path.normpath(os.path.join(_BUILD_DIR, "libjtentropy.so"))

_lib = None
_build_lock = threading.Lock()
_NTHREADS = max(1, os.cpu_count() or 1)
_ABI_VERSION = 15  # bump together with jt_abi_version() in entropy.cc


def _spec_min_bytes() -> int:
    """Speculative-prescan threshold from JPEG_TPU_SPEC_PRESCAN: unset/empty
    -> 0 (kernel default, 256 KiB); '0' disables; any other integer is the
    minimum segment size in bytes."""
    v = os.environ.get("JPEG_TPU_SPEC_PRESCAN", "")
    if not v:
        return 0
    try:
        n = int(v)
    except ValueError:
        return 0
    return -1 if n == 0 else n


class _CHuffTable(C.Structure):
    _fields_ = [
        ("lut_value", C.c_void_p),
        ("lut_size", C.c_void_p),
        ("delta", C.c_void_p),
        ("maxcode", C.c_void_p),
        ("values", C.c_void_p),
        ("ac_lut_value", C.c_void_p),
        ("ac_lut_run_size", C.c_void_p),
        ("fast_value", C.c_void_p),
        ("fast_run", C.c_void_p),
        ("fast_bits", C.c_void_p),
        ("fast_packed", C.c_void_p),
        ("fast2", C.c_void_p),
    ]


class _CScanComp(C.Structure):
    _fields_ = [
        ("h_samp", C.c_int32),
        ("v_samp", C.c_int32),
        ("block_width", C.c_int32),
        ("store", C.c_void_p),
        ("dc", C.c_void_p),
        ("ac", C.c_void_p),
        ("store_elems", C.c_int64),
    ]


class _CPrefixComp(C.Structure):
    _fields_ = [
        ("dc", C.c_void_p),
        ("ac", C.c_void_p),
        ("base", C.c_int64),
        ("nblocks", C.c_int64),
    ]


class _CUpsampleSpec(C.Structure):
    _fields_ = [
        ("plane", C.c_void_p),
        ("stride", C.c_int64),
        ("width", C.c_int32),
        ("height", C.c_int32),
        ("mode", C.c_int32),
        ("h_scale", C.c_int32),
        ("v_scale", C.c_int32),
    ]


class _CPrescanParams(C.Structure):
    _fields_ = [
        ("pos", C.c_int64),
        ("ncomp", C.c_int32),
        ("max_mcu_x", C.c_int32),
        ("max_mcu_y", C.c_int32),
        ("image_w", C.c_int32),
        ("image_h", C.c_int32),
        ("restart_interval", C.c_int32),
        ("s_target", C.c_int32),
        ("k_cap", C.c_int32),
        ("s_max", C.c_int32),
        ("pattern_len", C.c_int32),
        ("pattern", C.c_int32 * 16),
        ("out_len", C.c_int64),
        ("n_anchors", C.c_int64),
        ("n_blocks", C.c_int32),
        ("pending_marker", C.c_int32),
        ("nthreads", C.c_int32),
        ("uniform_tables", C.c_int32),
        ("spec_min_bytes", C.c_int32),
    ]


class _CTranscodeParams(C.Structure):
    _fields_ = [
        ("ncomp", C.c_int32),
        ("interleaved", C.c_int32),
        ("max_mcu_x", C.c_int32),
        ("max_mcu_y", C.c_int32),
        ("image_w", C.c_int32),
        ("image_h", C.c_int32),
        ("pattern_len", C.c_int32),
        ("s_target", C.c_int32),
        ("k_cap", C.c_int32),
        ("max_span_bytes", C.c_int32),
        ("worst_block_bytes", C.c_int32),
        ("out_cap", C.c_int64),
        ("out_len", C.c_int64),
        ("n_anchors", C.c_int64),
        ("n_blocks", C.c_int32),
        ("pattern", C.c_int32 * 64),
        ("comp_bw", C.c_int32 * 4),
        ("comp_hs", C.c_int32 * 4),
        ("comp_vs", C.c_int32 * 4),
        ("comp_off", C.c_int64 * 4),
    ]


class _CScanParams(C.Structure):
    _fields_ = [
        ("pos", C.c_int64),
        ("ncomp", C.c_int32),
        ("is_progressive", C.c_int32),
        ("max_mcu_x", C.c_int32),
        ("max_mcu_y", C.c_int32),
        ("image_w", C.c_int32),
        ("image_h", C.c_int32),
        ("ss", C.c_int32),
        ("se", C.c_int32),
        ("ah", C.c_int32),
        ("al", C.c_int32),
        ("restart_interval", C.c_int32),
        ("nthreads", C.c_int32),
        ("out_marker", C.c_int32),
    ]


def _build() -> Optional[str]:
    # JPEG_TPU_NATIVE_SO points at a prebuilt library (e.g. an ASan/UBSan
    # instrumented build — tools/asan_check.sh); no rebuild, no mtime check.
    override = os.environ.get("JPEG_TPU_NATIVE_SO")
    if override:
        return override if os.path.exists(override) else None
    with _build_lock:
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_CPP):
            return _SO
        tmp = f"{_SO}.{os.getpid()}.tmp"
        try:
            os.makedirs(os.path.dirname(_SO), exist_ok=True)
            subprocess.run(
                # -fwrapv: signed overflow is DEFINED to wrap — the kernels
                # deliberately mirror the reference's wrapping arithmetic on
                # malicious inputs (src/idct.rs:1-3), so the
                # language semantics must match, not just the usual codegen.
                ["g++", "-O3", "-march=native", "-fwrapv", "-shared", "-fPIC",
                 "-std=c++17", "-o", tmp, _CPP, "-lpthread"],
                check=True, capture_output=True, timeout=240)
            os.replace(tmp, _SO)
            return _SO
        except subprocess.CalledProcessError as e:
            # A broken native build must be LOUD: silently decoding on the
            # 100x-slower Python oracle once cost a full debugging session.
            import sys
            sys.stderr.write(
                "jpeg_decoder_tpu_torch.host: native entropy kernel failed to build — "
                "falling back to the Python oracle.\n"
                + e.stderr.decode("utf-8", "replace")[-2000:] + "\n")
            return None
        except Exception:
            return None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so = _build()
    if so is None:
        return None
    lib = C.CDLL(so)
    try:
        lib.jt_abi_version.restype = C.c_int64
        if lib.jt_abi_version() != _ABI_VERSION:
            return None
    except Exception:
        return None
    lib.jt_decode_scan_dct.restype = C.c_int
    lib.jt_decode_scan_dct.argtypes = [
        C.c_char_p, C.c_uint64, C.POINTER(_CScanParams), C.POINTER(_CScanComp),
        C.c_char_p]
    lib.jt_decode_scan_lossless.restype = C.c_int
    lib.jt_decode_scan_lossless.argtypes = [
        C.c_char_p, C.c_uint64, C.POINTER(C.c_int64), C.c_int32,
        C.POINTER(C.c_void_p), C.c_int32, C.c_int32, C.c_int32,
        C.POINTER(C.c_int32), C.POINTER(C.c_int32), C.c_void_p, C.c_char_p]
    lib.jt_reconstruct_lossless.restype = None
    lib.jt_reconstruct_lossless.argtypes = [
        C.c_void_p, C.c_int32, C.c_int32, C.c_int32, C.c_int32, C.c_int32,
        C.c_int32, C.c_void_p]
    lib.jt_pack_coo.restype = C.c_int64
    lib.jt_pack_coo.argtypes = [
        C.c_void_p, C.c_int64, C.c_int64, C.c_void_p, C.c_void_p, C.c_int64]
    lib.jt_zero.restype = None
    lib.jt_zero.argtypes = [C.c_void_p, C.c_int64]
    lib.jt_pack_prefix.restype = C.c_int64
    lib.jt_pack_prefix.argtypes = [
        C.c_void_p, C.c_int64, C.c_int32, C.c_int64, C.c_void_p, C.c_void_p,
        C.c_void_p, C.c_void_p, C.c_int64]
    lib.jt_decode_scan_dct_prefix.restype = C.c_int
    lib.jt_decode_scan_dct_prefix.argtypes = [
        C.c_char_p, C.c_uint64, C.POINTER(_CScanParams), C.POINTER(_CScanComp),
        C.POINTER(_CPrefixComp), C.c_int32, C.c_void_p, C.c_void_p, C.c_int64,
        C.POINTER(C.c_int64), C.c_char_p]
    lib.jt_decode_scan_dct_prefix_anchored.restype = C.c_int
    lib.jt_decode_scan_dct_prefix_anchored.argtypes = [
        C.c_void_p, C.c_int64, C.POINTER(_CScanParams), C.POINTER(_CScanComp),
        C.POINTER(_CPrefixComp), C.c_int32, C.c_void_p, C.c_void_p, C.c_void_p,
        C.c_int64, C.c_void_p, C.c_void_p, C.c_int64, C.POINTER(C.c_int64)]
    lib.jt_prescan_baseline.restype = C.c_int
    lib.jt_prescan_baseline.argtypes = [
        C.c_char_p, C.c_int64, C.POINTER(_CPrescanParams), C.c_void_p,
        C.c_void_p, C.c_int64, C.c_void_p, C.c_void_p, C.c_void_p,
        C.c_void_p, C.c_void_p, C.c_int64]
    lib.jt_transcode_scan.restype = C.c_int
    lib.jt_transcode_scan.argtypes = [
        C.c_void_p, C.POINTER(_CTranscodeParams), C.c_void_p, C.c_void_p,
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p,
        C.c_void_p, C.c_void_p, C.c_void_p]
    lib.jt_pack_slots.restype = None
    lib.jt_pack_slots.argtypes = [
        C.c_void_p, C.c_int64, C.c_void_p, C.c_int64, C.c_int64, C.c_int32,
        C.c_void_p, C.c_int32]
    lib.jt_pack_delta.restype = C.c_int
    lib.jt_pack_delta.argtypes = [
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p,
        C.c_int64, C.c_void_p, C.c_void_p, C.c_void_p]
    lib.jt_idct_component.restype = None
    lib.jt_idct_component.argtypes = [
        C.c_void_p, C.c_void_p, C.c_int64, C.c_int64, C.c_int32, C.c_void_p,
        C.c_int64, C.c_int32]
    lib.jt_upsample_color.restype = None
    lib.jt_upsample_color.argtypes = [
        C.POINTER(_CUpsampleSpec), C.c_int32, C.c_int32, C.c_int32, C.c_int32,
        C.c_void_p, C.c_int32]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _huff_ptr(table):
    """Build (and cache on the table object) the C view of a HuffmanTable."""
    cached = getattr(table, "_c_struct", None)
    if cached is not None:
        return cached[0]
    # Keep strong refs to the backing numpy buffers alongside the struct.
    values = np.ascontiguousarray(table.values, dtype=np.uint8)
    refs = [values]
    st = _CHuffTable(
        lut_value=table.lut_value.ctypes.data,
        lut_size=table.lut_size.ctypes.data,
        delta=table.delta.ctypes.data,
        maxcode=table.maxcode.ctypes.data,
        values=values.ctypes.data,
        ac_lut_value=table.ac_lut_value.ctypes.data if table.ac_lut_value is not None else None,
        ac_lut_run_size=(table.ac_lut_run_size.ctypes.data
                         if table.ac_lut_run_size is not None else None),
        fast_value=table.fast_value.ctypes.data,
        fast_run=table.fast_run.ctypes.data,
        fast_bits=table.fast_bits.ctypes.data,
        fast_packed=table.fast_packed.ctypes.data,
        fast2=table.fast2.ctypes.data if table.fast2 is not None else None,
    )
    table._c_struct = (st, refs)
    return st


def _raise(code: int, msg: bytes) -> None:
    if code == 1:
        raise FormatError(msg.decode("utf-8", "replace"))
    if code == 2:
        raise IoError()
    raise FormatError(f"native entropy error {code}")


def _build_scan_args(frame, scan, dc_tables, ac_tables, stores, restart_interval,
                     cursor):
    from ..parser import CodingProcess as _CP
    components = [frame.components[i] for i in scan.component_indices]
    is_interleaved = len(components) > 1

    comps = (_CScanComp * len(components))()
    keepalive = []
    for i, c in enumerate(components):
        dc = dc_tables[scan.dc_table_indices[i]]
        ac = ac_tables[scan.ac_table_indices[i]]
        dc_st = _huff_ptr(dc) if dc is not None else None
        ac_st = _huff_ptr(ac) if ac is not None else None
        keepalive.extend([dc, ac, dc_st, ac_st])
        comps[i].h_samp = c.horizontal_sampling_factor if is_interleaved else 1
        comps[i].v_samp = c.vertical_sampling_factor if is_interleaved else 1
        comps[i].block_width = c.block_size.width
        store = stores[i] if stores is not None else None
        comps[i].store = store.ctypes.data if store is not None else None
        comps[i].dc = C.addressof(dc_st) if dc_st is not None else None
        comps[i].ac = C.addressof(ac_st) if ac_st is not None else None
        comps[i].store_elems = store.size if store is not None else 0

    sp = _CScanParams(
        pos=cursor.pos,
        ncomp=len(components),
        is_progressive=1 if frame.coding_process == _CP.DCT_PROGRESSIVE else 0,
        max_mcu_x=frame.mcu_size.width if is_interleaved else components[0].block_size.width,
        max_mcu_y=frame.mcu_size.height if is_interleaved else components[0].block_size.height,
        image_w=frame.image_size.width,
        image_h=frame.image_size.height,
        ss=scan.spectral_selection_start,
        se=scan.spectral_selection_end,
        ah=scan.successive_approximation_high,
        al=scan.successive_approximation_low,
        restart_interval=restart_interval,
        nthreads=_NTHREADS,
        out_marker=-1,
    )
    return components, comps, sp, keepalive


def decode_scan_dct(cursor, frame, scan, dc_tables, ac_tables, restart_interval: int,
                    stores: list) -> Optional[int]:
    """Native counterpart of scan_python.decode_scan_dct (same contract)."""
    lib = _load()
    components, comps, sp, keepalive = _build_scan_args(
        frame, scan, dc_tables, ac_tables, stores, restart_interval, cursor)

    err = C.create_string_buffer(160)
    code = lib.jt_decode_scan_dct(cursor.data, len(cursor.data), C.byref(sp),
                                  comps, err)
    if code != 0:
        cursor.pos = len(cursor.data)  # conservative: stream consumed
        _raise(code, err.value)
    cursor.pos = sp.pos
    return sp.out_marker if sp.out_marker >= 0 else None


def decode_scan_dct_prefix(cursor, frame, scan, dc_tables, ac_tables,
                           restart_interval: int, dc_arrays: list,
                           ac_arrays: list, bases: list, prefix_k: int,
                           resid_idx, resid_vals, resid_count: int) -> tuple:
    """Baseline scan decode emitting the compact prefix format directly (no
    dense store). dc_arrays[i] is int16 [nblocks], ac_arrays[i] is int8
    [nblocks, K-1] (both zero-initialized), or None (dummy).
    Returns (marker, new_resid_count)."""
    lib = _load()
    components, comps, sp, keepalive = _build_scan_args(
        frame, scan, dc_tables, ac_tables, None, restart_interval, cursor)

    pcomps = (_CPrefixComp * len(components))()
    for i in range(len(components)):
        dc_arr, ac_arr = dc_arrays[i], ac_arrays[i]
        pcomps[i].dc = dc_arr.ctypes.data if dc_arr is not None else None
        pcomps[i].ac = ac_arr.ctypes.data if ac_arr is not None else None
        pcomps[i].base = bases[i]
        pcomps[i].nblocks = dc_arr.size if dc_arr is not None else 0

    count = C.c_int64(resid_count)
    err = C.create_string_buffer(160)
    code = lib.jt_decode_scan_dct_prefix(
        cursor.data, len(cursor.data), C.byref(sp), comps, pcomps, prefix_k,
        resid_idx.ctypes.data, resid_vals.ctypes.data, resid_idx.size,
        C.byref(count), err)
    if code != 0:
        cursor.pos = len(cursor.data)
        _raise(code, err.value)
    cursor.pos = sp.pos
    return (sp.out_marker if sp.out_marker >= 0 else None), count.value


def decode_scan_dct_prefix_anchored(cursor, frame, scan, dc_tables, ac_tables,
                                    dc_arrays: list, ac_arrays: list,
                                    bases: list, prefix_k: int,
                                    resid_idx, resid_vals, resid_count: int,
                                    ubytes: np.ndarray, anchor_bits,
                                    anchor_block, anchor_slot):
    """Multi-thread anchored decode of a prescanned baseline scan (entropy.cc
    jt_decode_scan_dct_prefix_anchored). `ubytes`/anchors come from
    prescan_baseline (which already advanced the cursor past the scan).
    Returns the new residual count, or None when the kernel elects serial
    fallback — outputs are wiped; the caller must restore the cursor and
    rerun decode_scan_dct_prefix."""
    lib = _load()
    components, comps, sp, keepalive = _build_scan_args(
        frame, scan, dc_tables, ac_tables, None, 0, cursor)

    pcomps = (_CPrefixComp * len(components))()
    for i in range(len(components)):
        dc_arr, ac_arr = dc_arrays[i], ac_arrays[i]
        pcomps[i].dc = dc_arr.ctypes.data if dc_arr is not None else None
        pcomps[i].ac = ac_arr.ctypes.data if ac_arr is not None else None
        pcomps[i].base = bases[i]
        pcomps[i].nblocks = dc_arr.size if dc_arr is not None else 0

    a_bits = np.ascontiguousarray(anchor_bits, np.uint32)
    a_block = np.ascontiguousarray(anchor_block, np.int32)
    a_slot = np.ascontiguousarray(anchor_slot, np.int32)
    ubytes = np.ascontiguousarray(ubytes, np.uint8)
    count = C.c_int64(resid_count)
    code = lib.jt_decode_scan_dct_prefix_anchored(
        ubytes.ctypes.data, ubytes.size, C.byref(sp), comps, pcomps, prefix_k,
        a_bits.ctypes.data, a_block.ctypes.data, a_slot.ctypes.data,
        a_bits.size, resid_idx.ctypes.data, resid_vals.ctypes.data,
        resid_idx.size, C.byref(count))
    if code != 0:
        return None
    return count.value


def decode_scan_lossless(cursor, frame, scan, dc_tables, restart_interval: int):
    """Native counterpart of scan_python.decode_scan_lossless (same contract)."""
    lib = _load()
    ncomp = len(scan.component_indices)
    w = frame.image_size.width
    h = frame.image_size.height

    tables = []
    ptrs = (C.c_void_p * ncomp)()
    for i in range(ncomp):
        t = dc_tables[scan.dc_table_indices[i]]
        st = _huff_ptr(t)
        tables.append((t, st))
        ptrs[i] = C.addressof(st)

    diffs = np.zeros((ncomp, h, w), dtype=np.int32)
    pos = C.c_int64(cursor.pos)
    marker = C.c_int32(-1)
    leftover = C.c_int32(0)
    err = C.create_string_buffer(160)
    code = lib.jt_decode_scan_lossless(
        cursor.data, len(cursor.data), C.byref(pos), ncomp, ptrs, w, h,
        restart_interval, C.byref(marker), C.byref(leftover),
        diffs.ctypes.data, err)
    if code != 0:
        cursor.pos = len(cursor.data)
        _raise(code, err.value)
    cursor.pos = pos.value
    return (marker.value if marker.value >= 0 else None), diffs, leftover.value


def prescan_baseline(cursor, luts: np.ndarray, geometry: dict,
                     s_target: int, k_cap: int, s_max: int):
    """Run the C++ prescan (entropy.cc jt_prescan_baseline). Returns
    (out_bytes: np.uint8 array, anchor_bits, anchor_block, anchor_slot,
    n_blocks, pending_marker) or None when the stream needs the host path.
    Advances cursor.pos past the scan on success."""
    lib = _load()
    assert lib is not None
    pp = _CPrescanParams()
    pp.pos = cursor.pos
    pp.ncomp = geometry["ncomp"]
    pp.max_mcu_x = geometry["max_mcu_x"]
    pp.max_mcu_y = geometry["max_mcu_y"]
    pp.image_w = geometry["image_w"]
    pp.image_h = geometry["image_h"]
    pp.restart_interval = geometry["restart_interval"]
    pp.s_target = s_target
    pp.k_cap = k_cap
    pp.s_max = s_max
    pattern = geometry["pattern"]
    pp.pattern_len = len(pattern)
    pp.nthreads = _NTHREADS
    pp.uniform_tables = geometry.get("uniform_tables", 0)
    pp.spec_min_bytes = _spec_min_bytes()
    for i, ci in enumerate(pattern):
        pp.pattern[i] = ci

    span = len(cursor.data) - cursor.pos
    nseg = geometry["est_segments"]
    # np.empty: the kernel zero-fills every guard region itself and the
    # anchor arrays are only read up to n_anchors — zeroing ~2 MB here cost
    # a measurable slice of staging latency.
    out = np.empty(span + 24 * (nseg + 2) + 64, np.uint8)
    cap = geometry["est_blocks"] + 2
    a_bits = np.empty(cap, np.uint32)
    a_block = np.empty(cap, np.int32)
    a_slot = np.empty(cap, np.int32)
    a_end = np.empty(cap, np.uint32)
    a_syms = np.empty(cap, np.int32)
    luts = np.ascontiguousarray(luts, np.uint32)
    status = lib.jt_prescan_baseline(
        cursor.data, len(cursor.data), C.byref(pp),
        luts.ctypes.data_as(C.c_void_p),
        out.ctypes.data, len(out),
        a_bits.ctypes.data, a_block.ctypes.data, a_slot.ctypes.data,
        a_end.ctypes.data, a_syms.ctypes.data, cap)
    if status != 0:
        return None
    cursor.pos = pp.pos
    n = pp.n_anchors
    pending = pp.pending_marker if pp.pending_marker >= 0 else None
    return (out[:pp.out_len], a_bits[:n], a_block[:n], a_slot[:n],
            pp.n_blocks, pending, a_end[:n], a_syms[:n])


def pack_delta_meta(a_bits: np.ndarray, a_block: np.ndarray,
                    a_slot: np.ndarray, c_end: np.ndarray,
                    c_syms: np.ndarray, n: int, dm_out: np.ndarray):
    """One C pass (entropy.cc jt_pack_delta, ABI 15) emitting the 4 B/chunk
    delta-wire words into dm_out[:n+1] plus per-class (count, max syms).
    Returns (cls_count, cls_syms) int32[8] or None on fallback. Inputs must
    be the prescan's contiguous arrays; a_block needs n+1 entries."""
    lib = _load()
    assert lib is not None
    a_bits = np.ascontiguousarray(a_bits, np.uint32)
    a_block = np.ascontiguousarray(a_block, np.int32)
    a_slot = np.ascontiguousarray(a_slot, np.int32)
    c_end = np.ascontiguousarray(c_end, np.uint32)
    c_syms = np.ascontiguousarray(c_syms, np.int32)
    cls_count = np.zeros(8, np.int32)
    cls_syms = np.zeros(8, np.int32)
    assert dm_out.size >= n + 1 and dm_out.dtype == np.uint32
    code = lib.jt_pack_delta(
        a_bits.ctypes.data, a_block.ctypes.data, a_slot.ctypes.data,
        c_end.ctypes.data, c_syms.ctypes.data, n,
        dm_out.ctypes.data, cls_count.ctypes.data, cls_syms.ctypes.data)
    if code != 0:
        return None
    return cls_count, cls_syms


def transcode_scan(stores_concat: np.ndarray, geometry: dict,
                   dc_code: np.ndarray, dc_len: np.ndarray,
                   ac_code: np.ndarray, ac_len: np.ndarray,
                   s_target: int, k_cap: int,
                   max_span_bytes: int, worst_block_bytes: int):
    """Run the C++ store->bitstream transcoder (entropy.cc jt_transcode_scan);
    bit-identical to the Python mirror in transcode.py. Returns
    (out_bytes, a_bits, a_block, a_slot, c_end, c_syms, n_blocks) or None on
    fallback (unencodable value)."""
    lib = _load()
    assert lib is not None
    tp = _CTranscodeParams()
    tp.ncomp = geometry["ncomp"]
    tp.interleaved = geometry["interleaved"]
    tp.max_mcu_x = geometry["max_mcu_x"]
    tp.max_mcu_y = geometry["max_mcu_y"]
    tp.image_w = geometry["image_w"]
    tp.image_h = geometry["image_h"]
    pattern = geometry["pattern"]
    tp.pattern_len = len(pattern)
    tp.s_target = s_target
    tp.k_cap = k_cap
    tp.max_span_bytes = max_span_bytes
    tp.worst_block_bytes = worst_block_bytes
    for i, ci in enumerate(pattern):
        tp.pattern[i] = ci
    for i in range(geometry["ncomp"]):
        tp.comp_bw[i] = geometry["comp_bw"][i]
        tp.comp_hs[i] = geometry["comp_hs"][i]
        tp.comp_vs[i] = geometry["comp_vs"][i]
        tp.comp_off[i] = geometry["comp_off"][i]

    n_blocks_est = geometry["est_blocks"]
    cap = n_blocks_est + 2
    a_bits = np.zeros(cap, np.uint32)
    a_block = np.zeros(cap, np.int32)
    a_slot = np.zeros(cap, np.int32)
    c_end = np.zeros(cap, np.uint32)
    c_syms = np.zeros(cap, np.int32)
    stores_concat = np.ascontiguousarray(stores_concat, np.int16)

    out_cap = n_blocks_est * 96 + (1 << 16)
    for _ in range(2):
        out = np.empty(out_cap, np.uint8)
        tp.out_cap = out_cap
        status = lib.jt_transcode_scan(
            stores_concat.ctypes.data, C.byref(tp),
            dc_code.ctypes.data, dc_len.ctypes.data,
            ac_code.ctypes.data, ac_len.ctypes.data,
            out.ctypes.data, a_bits.ctypes.data, a_block.ctypes.data,
            a_slot.ctypes.data, c_end.ctypes.data, c_syms.ctypes.data)
        if status == 0:
            n = tp.n_anchors
            total = tp.out_len + 16   # mirror's window read-ahead padding
            out[tp.out_len:total] = 0
            return (out[:total], a_bits[:n], a_block[:n], a_slot[:n],
                    c_end[:n], c_syms[:n], tp.n_blocks)
        if status != 2:   # TC_FALLBACK
            return None
        out_cap = n_blocks_est * 300 + (1 << 16)   # TC_GROW: worst case
    return None


def pack_coo(store: np.ndarray, base: int, idx_out: np.ndarray,
             vals_out: np.ndarray) -> int:
    """Append nonzero (global index, value) pairs of `store` (int16, flat)
    starting at output slot 0; returns nnz written."""
    lib = _load()
    return lib.jt_pack_coo(store.ctypes.data, store.size, base,
                           idx_out.ctypes.data, vals_out.ctypes.data,
                           idx_out.size)


def zero_buffer(arr: np.ndarray) -> None:
    _load().jt_zero(arr.ctypes.data, arr.nbytes)


def pack_slots(words: np.ndarray, starts: np.ndarray, nb: int,
               slot_words: int, out: np.ndarray, nthreads: int = 1) -> None:
    """Fill one slot class of the Pallas interchange (transposed word rows).

    words: AnchoredScan.words (uint32, big-endian packed); starts: int64 byte
    offsets of the selected chunks; out: uint32/int32 [slot_words * nb]
    (may be uninitialised — pad columns are zeroed by the kernel)."""
    lib = _load()
    assert words.dtype == np.uint32 and words.flags.c_contiguous
    assert starts.dtype == np.int64 and starts.flags.c_contiguous
    lib.jt_pack_slots(words.ctypes.data, words.size, starts.ctypes.data,
                      starts.size, nb, slot_words, out.ctypes.data, nthreads)


def pack_prefix(store: np.ndarray, nblocks: int, k: int, base: int,
                dc_out: np.ndarray, ac_out: np.ndarray, resid_idx: np.ndarray,
                resid_vals: np.ndarray) -> int:
    """Zigzag-prefix (DC int16 + AC int8 + exceptions) packing of one store."""
    lib = _load()
    return lib.jt_pack_prefix(store.ctypes.data, nblocks, k, base,
                              dc_out.ctypes.data, ac_out.ctypes.data,
                              resid_idx.ctypes.data, resid_vals.ctypes.data,
                              resid_idx.size)


def reconstruct_lossless(diffs: np.ndarray, predictor: int, point_transform: int,
                         precision: int, restart_all: bool) -> np.ndarray:
    """Native scalar predictor reconstruction (all predictors, any Pt)."""
    lib = _load()
    h, w = diffs.shape
    diffs = np.ascontiguousarray(diffs, dtype=np.int32)
    out = np.empty((h, w), dtype=np.uint16)
    lib.jt_reconstruct_lossless(
        diffs.ctypes.data, h, w, int(predictor), point_transform, precision,
        1 if restart_all else 0, out.ctypes.data)
    return out


_MODE_IDS = {"h1v1": 0, "h2v1": 1, "h1v2": 2, "h2v2": 3, "generic": 4}
_TRANSFORM_IDS = {"None": 0, "RGB": 1, "YCbCr": 2, "CMYK": 3, "YCCK": 4}


def idct_component(store: np.ndarray, qt: np.ndarray, bw: int, bh: int,
                   scale: int) -> np.ndarray:
    """Exact dequant+IDCT of a full component grid -> u8 plane [bh*s, bw*s]."""
    lib = _load()
    plane = np.empty((bh * scale, bw * scale), np.uint8)
    qt = np.ascontiguousarray(qt, np.uint16)
    lib.jt_idct_component(store.ctypes.data, qt.ctypes.data, bw, bh, scale,
                          plane.ctypes.data, plane.shape[1], _NTHREADS)
    return plane


def upsample_color(planes: list, specs: list, transform_name: str,
                   out_w: int, out_h: int, ncomp: int) -> np.ndarray:
    """Fused upsample + color conversion of a whole image.

    specs[i] = (width, height, mode_name, h_scale, v_scale). For the raw/None
    transform the output layout is [H, W*ncomp] (per-row planar), else
    [H, W, ncomp].
    """
    lib = _load()
    cspecs = (_CUpsampleSpec * ncomp)()
    for i, (plane, (w, h, mode, hs, vs)) in enumerate(zip(planes, specs)):
        cspecs[i].plane = plane.ctypes.data
        cspecs[i].stride = plane.shape[1]
        cspecs[i].width = w
        cspecs[i].height = h
        cspecs[i].mode = _MODE_IDS[mode]
        cspecs[i].h_scale = hs
        cspecs[i].v_scale = vs
    tid = _TRANSFORM_IDS[transform_name]
    out = np.empty(out_h * out_w * ncomp, np.uint8)
    lib.jt_upsample_color(cspecs, ncomp, tid, out_w, out_h, out.ctypes.data,
                          _NTHREADS)
    if tid == 0:
        return out.reshape(out_h, out_w * ncomp)
    return out.reshape(out_h, out_w, ncomp)

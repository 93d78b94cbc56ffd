"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The kernels (`csrc/*.cu`, listed in SOURCES; the headers they include are
listed in HEADERS) link into one shared library with a plain C interface;
nothing here includes PyTorch's headers, so a cold build takes seconds, not
minutes. Each source compiles in its own nvcc process, all started together,
then one nvcc links them. The library lands in `build/torch_kernels/` at the
repository root, named by a hash of the sources, headers and flags, so an
edited source rebuilds and an unchanged one loads the existing file. Nothing
is compiled or loaded at import time: the first kernel launch calls
`load()`.

Each wrapper counts its launches in `LAUNCHES` (`count_launch`: one per
kernel launch, and nowhere else), so a caller can show that a run went
through the kernels; a batched call that is one launch counts one. A
wrapper called while a CUDA graph is captured (`graph_scope` with
`capturing` set, `models/graphs.py`) launches nothing: its count goes to
the scope's tally, which each replay of the graph adds to `LAUNCHES`
(`count`, which the mesh's exchanges count through too).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("huffman_decode.cu", "dequant_idct.cu", "fused_tail.cu",
           "fused_recon.cu", "lossless_recur.cu", "idct_exact.cu",
           "interleaved_tail.cu", "assemble.cu", "unpack_delta.cu",
           "prefix_rebuild.cu", "dc_totals.cu")
HEADERS = ("idct_mma.cuh",)    # included by sources; part of the hash
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Kernel launch counts, by kernel name; see reset_launches().
LAUNCHES = {"huffman_decode": 0, "dequant_idct": 0, "fused_tail": 0,
            "fused_recon": 0, "lossless_recur": 0, "idct_exact": 0,
            "interleaved_tail": 0, "assemble": 0, "unpack_delta": 0,
            "prefix_rebuild": 0, "dc_totals": 0}

_lock = threading.Lock()
_lib = None
build_seconds = None    # wall time of the nvcc runs in this process, if any
ptxas_log = ""          # ptxas's registers / shared memory / spills report


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count(counts: dict, name: str, n: int = 1) -> None:
    """Add `n` to `counts[name]` (`LAUNCHES`, or another count of what the
    device does, as `parallel.mesh.EXCHANGED`), or to the tally of the
    graph this thread is capturing (`graph_scope`), which each replay of
    the graph adds to `counts` (`add_tally`)."""
    scope = getattr(_local, "scope", None)
    if scope is not None and scope.capturing:
        mine = scope.tally.setdefault(id(counts), (counts, {}))[1]
        mine[name] = mine.get(name, 0) + n
    else:
        counts[name] += n


def count_launch(name: str, n: int = 1) -> None:
    """Count `n` launches of kernel `name` (`count` into `LAUNCHES`)."""
    count(LAUNCHES, name, n)


def add_tally(tally: dict) -> None:
    """One replay of a captured graph: its tally (`GraphScope.tally`, the
    launches and the rest its capture counted) added to the counts it was
    taken from."""
    for counts, by_name in tally.values():
        for name, n in by_name.items():
            counts[name] += n


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libjdt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global build_seconds, ptxas_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{name}.o") for name in SOURCES]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    try:
        for name, obj in zip(SOURCES, objs):
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        logs = []
        for name, proc in zip(SOURCES, procs):
            _out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed on {name} ({proc.returncode}):\n"
                    f"{err[-4000:]}")
            logs.append(err)
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                              *map(str, objs)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise KernelBuildError(
                f"nvcc link failed ({res.returncode}):\n{res.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in (*objs, tmp):     # tmp is gone after a good build
            path.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    ptxas_log = "".join(logs)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load the library once per process, declare argtypes."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.jdt_huffman_decode.argtypes = [
            p, i,           # words, n_words
            p, p, p, i,     # dm, ab, base, n_items
            p, p, p, p, p,  # maxcode, delta, values, lut, walk
            i,              # n_tab
            p, i, p,        # pattern, plen, unzig
            i,              # s_max
            p, i,           # nat, n_blocks
            p]              # stream
        lib.jdt_huffman_decode.restype = i
        lib.jdt_dequant_idct.argtypes = [
            p, p, p,        # host void*[nseg]: coefs, folded bases, outs
            p, p,           # host int32[nseg]: block counts, scales
            i,              # nseg, the segments (1..64)
            p]              # stream
        lib.jdt_dequant_idct.restype = i
        lib.jdt_fused_tail.argtypes = [
            p, p, p, p,     # component planes 0..3 of image 0 (unused: 0)
            p,              # host int64[12]: mode codes, row pitches and
                            # image strides in bytes, per component
            i, i,           # ncomp, transform
            i, i, i, i,     # hc, wc, out_h, out_w
            i,              # images
            p,              # out, [images, ncomp, out_h, out_w]
            p]              # stream
        lib.jdt_fused_tail.restype = i
        lib.jdt_fused_recon.argtypes = [
            p, p, p,        # y, cb, cr stores
            p,              # folded bases [3, 64, 64]
            i, i, i,        # bh, bw, width
            p,              # out
            p]              # stream
        lib.jdt_fused_recon.restype = i
        lib.jdt_lossless_recur.argtypes = [
            p, i, i, i,     # diffs, ncomp, h, w
            i, i, i,        # predictor, pt, default prediction
            p,              # out
            p]              # stream
        lib.jdt_lossless_recur.restype = i
        lib.jdt_idct_exact.argtypes = [
            p, p, p,        # host void*[nseg]: coefs, int32 tables, outs
            p, p,           # host int32[nseg]: block counts, scales
            i,              # nseg, the segments (1..64)
            p]              # stream
        lib.jdt_idct_exact.restype = i
        lib.jdt_interleaved_tail.argtypes = [
            p, p,           # host void*[ncomp] pixels, void*[2 ncomp] halos
            p,              # host int64[ncomp][12]: per component geometry
            i, i,           # ncomp, transform
            i, i, i, i,     # out_h, out_w, row0, images
            p,              # out
            p,              # host int64[3 ncomp + 1]: the output layout
            p]              # stream
        lib.jdt_interleaved_tail.restype = i
        q = ctypes.c_longlong
        lib.jdt_assemble.argtypes = [
            p, q, i, i,     # nat, n_blocks, images, ncomp
            p,              # host int64[14 ncomp]: per component geometry
            i, p,           # general, host void*[4 ncomp]: its index maps
            p, q, q,        # carry (int64, or 0), its strides (c, n)
            p,              # out: every component's stores, one allocation
            p, q,           # status buffer (word 0 + words), its words
            ctypes.c_uint,  # epoch, or 0: the epoch in word 0
            p]              # stream
        lib.jdt_assemble.restype = i
        lib.jdt_unpack_delta.argtypes = [
            p, q,           # dm, n
            p, p,           # ab, base
            p, q,           # status buffer (word 0 + words), its words
            ctypes.c_uint,  # epoch, or 0: the epoch in word 0
            p]              # stream
        lib.jdt_unpack_delta.restype = i
        lib.jdt_prefix_rebuild.argtypes = [
            p, p, q,        # dc, ac, blocks
            p, p, q,        # resid_idx, resid_vals, entries
            p,              # out
            p]              # stream
        lib.jdt_prefix_rebuild.restype = i
        lib.jdt_dc_totals.argtypes = [
            p, q, i,        # nat, n_mcus, plen
            i, i,           # images, ncomp
            p,              # host int64[2 ncomp]: s0, bpm per component
            p,              # out, int64 [images, ncomp]
            p, q,           # status buffer (word 0, accumulators), its
                            # words past word 0
            p]              # stream
        lib.jdt_dc_totals.restype = i
        lib.jdt_dc_totals_status_words.argtypes = [i, i]  # images, ncomp
        lib.jdt_dc_totals_status_words.restype = q
        lib.jdt_error_string.argtypes = [i]
        lib.jdt_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


# Per (kernel, device, stream): a status buffer of a decoupled look-back
# (int64: the ticket counter, then the tiles' status words) and the last
# epoch used on it. A new epoch for every launch keeps the words of earlier
# launches from reading as valid, so a buffer is zeroed only when it is
# made (or outgrown, or its epochs run out). Each kernel has its own, so
# two kernels on one stream never spend each other's epochs. D1
# (`dc_totals`) takes its accumulators from one too, and needs no epoch:
# the CTA that completes an accumulator sets it back to 0. It has no
# ticket, but keeps the layout (its words past word 0, which it leaves
# alone) so that every kernel sizes and passes its buffer alike and a
# ticketed variant of D1 (tools/experiments/p1d1_breakdown.py) takes the
# same buffer.
_status: dict = {}
_status_lock = threading.Lock()
_local = threading.local()     # .scope: the GraphScope this thread runs in


class DeviceEpochs:
    """Status buffers whose epoch lives on the card, for the launches of one
    captured graph (`models/graphs.py`): one buffer per launch site, the
    k-th launch of a kernel in the graph's body taking the kernel's k-th
    buffer. Word 0 holds the epoch in its high 32 bits and the ticket
    counter in its low 32: each CTA's 64-bit atomicAdd of 1 returns its
    ticket and the launch's epoch together, and the CTA that takes the last
    ticket stores the next epoch (mod 2^epoch bits: 2^32 for A1, 2^30 for
    U1) with the counter 0, in one atomic. A replay launches the same
    kernel on the same tile count, and every tile publishes its status, so
    after a launch every word a later launch reads carries that launch's
    epoch, which the next launch's differs from: a word not yet published
    in this launch never reads as valid, across the wrap too, and no
    buffer is ever cleared. The wrapper passes epoch 0 (no host epoch) for
    such a buffer."""

    def __init__(self, device):
        self.device = device
        self.buffers: dict = {}     # kernel -> [int64 buffer, ...]
        self._next: dict = {}       # kernel -> launch sites used this run

    def begin(self) -> None:
        """A new run of the body: launch sites count from 0 again."""
        self._next.clear()

    def buffer(self, kernel: str, words: int, capturing: bool):
        import torch

        k = self._next.get(kernel, 0)
        self._next[kernel] = k + 1
        bufs = self.buffers.setdefault(kernel, [])
        if k < len(bufs) and bufs[k].numel() - 1 >= words:
            return bufs[k]
        if capturing:
            # Memory taken under a capture comes from the graph's pool,
            # whose blocks freed earlier in the body an earlier node of the
            # graph writes at every replay: no state survives there.
            raise RuntimeError(f"{kernel}: no device-epoch status buffer of "
                               f"{words} words for launch site {k}; the "
                               "warm-up run must make it before capture")
        buf = torch.zeros(1 + max(words, 1), dtype=torch.int64,
                          device=self.device)
        if k < len(bufs):
            bufs[k] = buf
        else:
            bufs.append(buf)
        return buf


@dataclasses.dataclass
class GraphScope:
    """What the wrappers read while a graph's body runs on this thread: its
    device-epoch status buffers, and while `capturing`, the tally of the
    launches (and exchanged bytes) the capture records (`count`): by the
    id of the counts they go to, (counts, {name: n})."""
    epochs: DeviceEpochs
    capturing: bool = False
    tally: dict = dataclasses.field(default_factory=dict)


@contextlib.contextmanager
def graph_scope(scope: GraphScope):
    """Run a graph's body (eagerly, or under capture) in `scope`."""
    prev = getattr(_local, "scope", None)
    _local.scope = scope
    scope.epochs.begin()
    try:
        yield scope
    finally:
        _local.scope = prev


def status_buffer(kernel: str, dev, stream: int, words: int,
                  epoch_bits: int) -> tuple:
    """(buffer, epoch) for one launch of `kernel` on (`dev`, `stream`) that
    needs `words` status words: the buffer int64 [1 + at least `words`],
    the epoch new on it, 1 .. 2^epoch_bits - 1. Inside a `graph_scope`:
    the scope's device-epoch buffer for this launch site and epoch 0 (the
    kernel takes its epoch from the buffer's word 0)."""
    import torch

    scope = getattr(_local, "scope", None)
    if scope is not None:
        return scope.epochs.buffer(kernel, words, scope.capturing), 0
    with _status_lock:
        entry = _status.get((kernel, dev, stream))
        if entry is None or entry[0].numel() - 1 < words \
                or entry[1] >= (1 << epoch_bits) - 1:
            size = max(4096, 1 << (max(words, 1) - 1).bit_length())
            entry = _status[kernel, dev, stream] = [
                torch.zeros(size + 1, dtype=torch.int64, device=dev), 0]
        entry[1] += 1
        return entry[0], entry[1]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        msg = lib.jdt_error_string(err).decode("utf-8", "replace")
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({msg})")

"""Host-to-card copies: page-locked staging buffers and non-blocking H2D.

The counterpart of the JAX package's asynchronous `jax.device_put`: `put`
copies a tuple of numpy arrays (one image's or one group's wire) into one
page-locked (pinned) host buffer, each at a 256-byte aligned offset, and
enqueues a copy of each to the card with `non_blocking=True`, so the
calling thread does not wait for the card. A copy from pageable memory
would wait (PyTorch's blocking `.to(device)` synchronises the stream after
the copy, so the dispatching thread would wait for every kernel enqueued
before it).

`put` runs on the stream's dispatch thread, beside the staging threads,
which hold the GIL for their Python: every PyTorch call that drops the
GIL can wait there for up to the interpreter's switch interval to get it
back (`tools/experiments/h2d_probe.py` measures it). So the host copies
are numpy's and the views are made on the host, leaving one PyTorch call
per array (the copy to the card) and one event per submission.

`PinnedPool` holds the buffers, one pool per CUDA device in the process
(`pinned_pool`), bounded as the host stage's `_BufferPool` is: at most
`depth` buffers per size class (powers of two, from 4 KiB) and `budget`
bytes in all. A buffer is taken again only after the CUDA event recorded
behind its copies has completed, the most recently released such buffer
first (its pages are the likeliest to be in cache); a put that finds
every buffer of its class busy at the class's depth, or the budget spent,
waits for the oldest copy. The buffers are numpy memory registered with
`cudaHostRegister` (page aligned, whole pages, so no two registrations
share a page) and unregistered, after their last copy, when the budget
evicts them or their pool is dropped, so the bound holds for the pinned
memory itself and freed memory is never left registered. An array larger
than the whole budget is copied synchronously from pageable memory.

`put_into` lands arrays in a tensor that already exists, at byte offsets
into it (a captured graph's input buffer, `models/graphs.py`): one pinned
buffer laid out as the tensor is, then one non-blocking copy.

On the CPU nothing pins: `put` wraps the array (`torch.from_numpy`), and
`put_into` writes the arrays into the tensor.
"""

from __future__ import annotations

import threading
import time
import weakref

import numpy as np
import torch

PAGE = 4096
ALIGN = 256     # each array's offset in a buffer: aligned for any dtype


def checked_device(device) -> torch.device:
    """`device` as a torch.device the port runs on: "cpu" when the caller
    asks for it, else CUDA, which raises where there is no card. "cuda"
    names the current card by its index ("cuda:N"), so one card is one
    device wherever devices are compared or key a cache."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _register(ptr: int, nbytes: int) -> None:
    err = int(torch.cuda.cudart().cudaHostRegister(ptr, nbytes, 0))
    if err:
        raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed "
                           f"with CUDA error {err}")


def _unregister(ptr: int) -> None:
    err = int(torch.cuda.cudart().cudaHostUnregister(ptr))
    if err:
        raise RuntimeError(f"cudaHostUnregister failed with CUDA error {err}")


def _retire(raw: np.ndarray, ptr: int, event) -> None:
    """Unregister a buffer once its last copy has run; `raw` (the memory)
    stays alive until then."""
    event.synchronize()
    _unregister(ptr)


class _Buffer:
    """One registered, page-aligned host buffer (`array`, uint8) and the
    event recorded after the last copy out of it. Dropping it, or
    `retire()`, unregisters the memory after that copy (not at interpreter
    exit, where the process's memory goes anyway)."""

    def __init__(self, size: int):
        raw = np.empty(size + PAGE, np.uint8)
        start = -raw.ctypes.data % PAGE
        array = raw[start:start + size]
        _register(array.ctypes.data, size)
        self.size = size
        self.array = array
        self.event = torch.cuda.Event()
        self.recorded = False
        self.retire = weakref.finalize(self, _retire, raw, array.ctypes.data,
                                       self.event)
        self.retire.atexit = False

    def ready(self) -> bool:
        return not self.recorded or self.event.query()

    def wait(self) -> None:
        self.event.synchronize()


class PinnedPool:
    """Page-locked host buffers for the copies to one CUDA device, bounded
    by `depth` buffers per size class and `budget` bytes in all (module
    docstring). `bytes` is what the pool holds now, `peak_bytes` the most
    it held, `copy_seconds` the host time spent filling buffers (the
    pageable-to-pinned copies) and `copied_bytes` their bytes."""

    def __init__(self, device, depth: int = 8, budget: int = 1 << 30):
        self.device = torch.device(device)
        self._depth = depth
        self._budget = budget
        self._cond = threading.Condition()
        self._free: dict = {}     # size -> [_Buffer], classes in LRU order
        self._held: dict = {}     # size -> buffers of the class, free or out
        self.bytes = 0
        self.peak_bytes = 0
        self.copy_seconds = 0.0
        self.copied_bytes = 0

    def _evict_one(self, keep: int) -> bool:
        """Free the least recently released buffer of another class than
        `keep` (after its copy has finished). Caller holds the lock."""
        for size, stack in self._free.items():
            if size != keep and stack:
                buf = stack.pop(0)
                if not stack:
                    del self._free[size]
                buf.retire()
                self._held[size] -= 1
                self.bytes -= size
                return True
        return False

    def _acquire(self, size: int) -> _Buffer:
        with self._cond:
            while True:
                stack = self._free.get(size, [])
                for i in reversed(range(len(stack))):  # the warmest first
                    if stack[i].ready():
                        return stack.pop(i)
                held = self._held.get(size, 0)
                if held < self._depth:
                    while self.bytes + size > self._budget \
                            and self._evict_one(size):
                        pass
                    if self.bytes + size <= self._budget:
                        buf = _Buffer(size)
                        self._held[size] = held + 1
                        self.bytes += size
                        self.peak_bytes = max(self.peak_bytes, self.bytes)
                        return buf
                if stack:                  # the oldest copy of the class
                    buf = stack.pop(0)
                    buf.wait()
                    return buf
                self._cond.wait()          # every buffer is being filled

    def _release(self, buf: _Buffer, seconds: float, nbytes: int) -> None:
        with self._cond:
            self.copy_seconds += seconds
            self.copied_bytes += nbytes
            stack = self._free.pop(buf.size, [])
            stack.append(buf)
            self._free[buf.size] = stack   # most recently released class last
            self._cond.notify_all()

    def put(self, arrays) -> tuple:
        """Non-blocking H2D copies of a tuple of arrays through one pinned
        buffer; each result has its array's dtype and shape."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        offs = [0]
        for a in arrays:
            offs.append(offs[-1] + -(-a.nbytes // ALIGN) * ALIGN)
        size = max(PAGE, 1 << max(offs[-1] - 1, 0).bit_length())
        if size > self._budget:
            return tuple(torch.from_numpy(a).to(self.device) for a in arrays)
        buf = self._acquire(size)
        seconds = 0.0
        try:
            t0 = time.perf_counter()
            views = []
            for a, off in zip(arrays, offs):
                host = buf.array[off:off + a.nbytes]
                host[...] = a.reshape(-1).view(np.uint8)
                views.append(torch.from_numpy(host.view(a.dtype)
                                              .reshape(a.shape)))
            seconds = time.perf_counter() - t0
            out = tuple(v.to(self.device, non_blocking=True) for v in views)
            buf.event.record(torch.cuda.current_stream(self.device))
            buf.recorded = True
        finally:
            self._release(buf, seconds, sum(a.nbytes for a in arrays))
        return out

    def put_into(self, dst: torch.Tensor, items) -> None:
        """Non-blocking H2D copy of `items`, (byte offset, array) pairs,
        into `dst` (contiguous uint8 on the pool's device) through one
        pinned buffer: one copy of dst's first bytes up to the last
        array's end."""
        end = max(off + a.nbytes for off, a in items)
        size = max(PAGE, 1 << max(end - 1, 0).bit_length())
        if size > self._budget:
            host = np.zeros(end, np.uint8)
            _fill(host, items)
            dst[:end].copy_(torch.from_numpy(host))
            return
        buf = self._acquire(size)
        seconds = 0.0
        try:
            t0 = time.perf_counter()
            _fill(buf.array, items)
            seconds = time.perf_counter() - t0
            dst[:end].copy_(torch.from_numpy(buf.array[:end]),
                            non_blocking=True)
            buf.event.record(torch.cuda.current_stream(self.device))
            buf.recorded = True
        finally:
            self._release(buf, seconds, sum(a.nbytes for _o, a in items))


def _fill(host: np.ndarray, items) -> None:
    """Each (byte offset, array) of `items` into the uint8 `host`."""
    for off, a in items:
        host[off:off + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)


_pools: dict = {}
_pools_lock = threading.Lock()


def pinned_pool(device) -> PinnedPool:
    """The process's pinned pool for one CUDA device."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _pools_lock:
        pool = _pools.get(dev)
        if pool is None:
            pool = _pools[dev] = PinnedPool(dev)
        return pool


def put(arrays, device: torch.device) -> tuple:
    """A tuple of arrays on `device`: one non-blocking copy through the
    device's pinned pool on a CUDA device; on the CPU the arrays
    themselves, wrapped."""
    if device.type == "cpu":
        return tuple(torch.from_numpy(np.ascontiguousarray(a))
                     for a in arrays)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return pinned_pool(device).put(arrays)


def put_into(dst: torch.Tensor, items) -> None:
    """(byte offset, array) pairs into the uint8 tensor `dst`: one
    non-blocking copy through the device's pinned pool on a CUDA device;
    on the CPU the arrays written in place."""
    if dst.dtype != torch.uint8 or dst.dim() != 1 \
            or not dst.is_contiguous():
        raise ValueError("put_into writes a contiguous 1-D uint8 tensor")
    if max(off + a.nbytes for off, a in items) > dst.numel():
        raise ValueError("an array lands past the end of the tensor")
    if dst.device.type == "cpu":
        _fill(dst.numpy(), items)
    elif dst.device.type == "cuda":
        pinned_pool(dst.device).put_into(dst, items)
    else:
        raise ValueError(f"unsupported device {dst.device}")

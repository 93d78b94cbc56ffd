#!/usr/bin/env python
"""Where the time of one host-to-card copy goes, on a CUDA card.

    python tools/experiments/h2d_probe.py [--iters N]

For arrays of 4 KiB, 64 KiB, 1 MiB and 8 MiB (seeded uint8), the host
time per call (host clock over N back-to-back calls, then one
synchronisation, divided by N) and the device time per call (CUDA events
around the same N calls) of:
- "put": `jpeg_decoder_tpu_torch.transfer.put`, the port's path (a
  pinned buffer from the device's pool, numpy's copy into it, a
  non-blocking copy, an event);
- "copy_into_pinned": PyTorch's `copy_` into a pinned buffer alone;
- "dma_from_pinned": `.to(device, non_blocking=True)` of a tensor that
  is already pinned;
- "pageable": `torch.from_numpy(a).to(device)`, the blocking copy from
  pageable memory the stream made before (it synchronises the stream).
Then the same "put" and "pageable" calls with the card busy (a ~20 ms
`torch.cuda._sleep` enqueued first): the host time shows whether the call
waits for the card. Then, for the wire sizes of the stream (32 KiB, about
tower_420's; 392 KiB, about large_420's), the host µs of one `copy_` of
the array into a buffer registered with `cudaHostRegister` (the pool's
kind), into one from PyTorch's pinned allocator, and into pageable
memory, and of one "put" and one "pageable" copy, each with the host idle
and with four threads staging large_420 (`stage_host_bits`) in a loop, as
`decode_stream`'s staging pool does around the dispatch thread. Prints one
JSON line with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

SIZES = (4 << 10, 64 << 10, 1 << 20, 8 << 20)
WIRE_SIZES = (32 << 10, 392 << 10)
FIXTURE = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / \
    "torch_port" / "large_420.jpg"


def _host_us(fn, iters: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return host * 1e6


def _under_load(dev, iters: int) -> dict:
    """Copies at the stream's wire sizes, idle and beside four staging
    threads."""
    from jpeg_decoder_tpu_torch import stage_host_bits
    from jpeg_decoder_tpu_torch.transfer import _Buffer, put

    blob = FIXTURE.read_bytes()
    rows = {}
    for load in ("idle", "staging x4"):
        stop = threading.Event()
        threads = [threading.Thread(
            target=lambda: [stage_host_bits(blob) for _ in iter(
                lambda: stop.is_set(), True)]) for _ in range(
                    4 if load != "idle" else 0)]
        for t in threads:
            t.start()
        time.sleep(0.5 if threads else 0)
        for size in WIRE_SIZES:
            a = np.random.default_rng(size).integers(0, 255, size, np.uint8)
            src = torch.from_numpy(a)
            buffer = _Buffer(1 << (size - 1).bit_length())   # kept alive
            registered = torch.from_numpy(buffer.array[:size])
            pinned = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            pageable = torch.empty(size, dtype=torch.uint8)
            rows[f"{load} {size}"] = {
                "copy_into_registered_us": _host_us(
                    lambda: registered.copy_(src), iters),
                "copy_into_pinned_us": _host_us(
                    lambda: pinned.copy_(src), iters),
                "copy_into_pageable_us": _host_us(
                    lambda: pageable.copy_(src), iters),
                "np_copyto_registered_us": _host_us(
                    lambda: np.copyto(registered.numpy(), a), iters),
                "put_us": _host_us(lambda: put((a,), dev), iters),
                "pageable_us": _host_us(lambda: src.to(dev), iters)}
        stop.set()
        for t in threads:
            t.join()
    return rows


def _times(fn, iters: int) -> dict:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters
    stop.record()
    stop.synchronize()
    return {"host_us": host * 1e6,
            "device_us": start.elapsed_time(stop) / iters * 1e3}


def _busy_host_us(fn) -> float:
    """Host time of one call made while the card runs a ~20 ms sleep."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("h2d_probe.py needs a CUDA device", file=sys.stderr)
        return 1
    from jpeg_decoder_tpu_torch.transfer import put

    dev = torch.device("cuda")
    rows = {}
    for size in SIZES:
        a = np.random.default_rng(size).integers(0, 255, size, np.uint8)
        src = torch.from_numpy(a)
        pinned = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        row = {
            "put": _times(lambda: put((a,), dev), args.iters),
            "copy_into_pinned": _times(lambda: pinned.copy_(src), args.iters),
            "dma_from_pinned": _times(
                lambda: pinned.to(dev, non_blocking=True), args.iters),
            "pageable": _times(lambda: src.to(dev), args.iters),
            "put_host_us_card_busy": _busy_host_us(lambda: put((a,), dev)),
            "pageable_host_us_card_busy": _busy_host_us(lambda: src.to(dev)),
        }
        for key in ("put", "dma_from_pinned", "pageable"):
            row[key]["gb_s"] = size / max(row[key]["host_us"],
                                          row[key]["device_us"]) / 1e3
        rows[size] = row
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "torch_threads": torch.get_num_threads(),
                      "bytes": rows, "wire": _under_load(dev, args.iters)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Where kernel L1's time goes, on a CUDA card: cycles per dependent step.

    python tools/experiments/l1_step_probe.py [--side N] [--predictor P]

L1 (jpeg_decoder_tpu_torch/csrc/lossless_recur.cu) walks a band of 32 rows
in one warp, lane l at column t - l in step t, each step one shuffle and a
few integer operations on values kept in registers; the bands hand their
last rows down through (distributed) shared memory. A plane therefore
takes at least H + W - 1 dependent steps. This probe builds the kernel
with L1_STEP_PROBE defined (clock64 around every edge-free phase of 16
steps, every wait on a handoff barrier, lane 0's take of the row above,
the copy wait, the store, lane 31's handoff, and at each band's start and
end) and prints one JSON line with:

- `step_cycles`: cycles of one step of the inner loop, from a [1, 64, 4096]
  plane (two bands, two warps: the second band's edge-free phases, with
  one other warp on the SM), and `loaded_step_cycles` from the full plane
  (its warps spread over a cluster of SMs);
- `register_step_cycles`: one step of a bare register chain (shuffle,
  predictor, mask and shift; no shared memory), the floor of a step;
- for the full [1, N, N] plane (default 2048): the kernel time (CUDA
  events, mean of 10 launches), the SM clock nvidia-smi reads while the
  kernel runs again,
  the share of each band's span spent computing edge-free phases, waiting
  on barriers and in each of the other parts, the start of every 8th
  band, and
  `chain_bound_us` = (H + W - 1) x `step_cycles` at that clock.

Needs nvcc and a CUDA device; fails without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "l1_probe"

FLOOR_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>
__device__ long long floor_cycles;
__global__ void floor_loop(int steps, int pt, int* sink) {
  int val = threadIdx.x * 977, rc = 0;
  const long long t0 = clock64();
  for (int t = 0; t < steps; ++t) {
    const int rb = __shfl_up_sync(0xffffffffu, val, 1);
    const int pred = rb + ((val - rc) >> 1);
    const unsigned v = (pred + (t ^ threadIdx.x)) & 0xFFFFu;
    val = static_cast<int>((v << pt) & 0xFFFFu);
    rc = rb;
  }
  if (threadIdx.x == 0) floor_cycles = clock64() - t0;
  if (val == 0x12345) sink[0] = val;
}
extern "C" double floor_cycles_per_step(int steps) {
  int* sink;
  cudaMalloc(&sink, 4);
  long long c = 0;
  for (int rep = 0; rep < 2; ++rep) {
    floor_loop<<<1, 32>>>(steps, 0, sink);
    cudaDeviceSynchronize();
  }
  cudaMemcpyFromSymbol(&c, floor_cycles, sizeof(c));
  cudaFree(sink);
  return static_cast<double>(c) / steps;
}
"""


def nvcc(src: Path, out: Path, *flags: str) -> None:
    from jpeg_decoder_tpu_torch import _build

    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    *flags, "-o", str(out), str(src)], check=True)


def run_plane(lib, shape, predictor: int, iters: int) -> dict:
    """Launch the probe build on a seeded plane; return its counters and
    the kernel time."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.integers(0, 65536, shape).astype(np.int32)) \
        .to(dev)
    out = torch.empty_like(d)
    stream = torch.cuda.current_stream().cuda_stream
    c, h, w = shape

    def launch():
        err = lib.jdt_lossless_recur(d.data_ptr(), c, h, w, predictor, 0,
                                     1 << 15, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"L1 launch failed: cudaError {err}")

    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        launch()
    stop.record()
    stop.synchronize()
    clocks = []

    def query():    # nvidia-smi takes ~0.1 s to answer: keep the card busy
        for _ in range(3):
            res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=60)
            clocks.extend(int(v) for v in res.stdout.split() if v.isdigit())

    smi = threading.Thread(target=query)
    smi.start()
    while smi.is_alive():
        launch()
        torch.cuda.synchronize()
    smi.join()
    probe = np.zeros((4096, 10), np.int64)
    if lib.jdt_l1_probe_read(probe.ctypes.data) != 0:
        raise RuntimeError("reading the probe's counters failed")
    nb = -(-h // 32)
    return {"kernel_us": start.elapsed_time(stop) / iters * 1e3,
            "sm_clock_mhz": clocks, "bands": probe[:nb]}


def build() -> tuple:
    """Compile the probe build of L1 and the register-chain floor; return
    both libraries, argtypes set."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = ROOT / "jpeg_decoder_tpu_torch" / "csrc" / "lossless_recur.cu"
    nvcc(src, OUT / "l1_probe.so", "-DL1_STEP_PROBE")
    (OUT / "floor.cu").write_text(FLOOR_CU)
    nvcc(OUT / "floor.cu", OUT / "floor.so")
    lib = ctypes.CDLL(str(OUT / "l1_probe.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.jdt_lossless_recur.argtypes = [p, i, i, i, i, i, i, p, p]
    lib.jdt_l1_probe_read.argtypes = [p]
    floor = ctypes.CDLL(str(OUT / "floor.so"))
    floor.floor_cycles_per_step.argtypes = [i]
    floor.floor_cycles_per_step.restype = ctypes.c_double
    return lib, floor


def measure_step(libs=None, predictor: int = 6) -> dict:
    """Cycles of one step of L1's inner loop (a [1, 64, 4096] plane: the
    second band's edge-free phases), of a bare register chain, and the SM
    clock (MHz) while the kernel runs."""
    lib, floor = libs or build()
    alone = run_plane(lib, (1, 64, 4096), predictor, 20)
    band = alone["bands"][1]
    return {"step_cycles": float(band[0] / band[1]),
            "register_step_cycles": floor.floor_cycles_per_step(100000),
            "sm_clock_mhz": float(np.median(alone["sm_clock_mhz"])),
            "device": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=2048)
    ap.add_argument("--predictor", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    libs = build()
    step = measure_step(libs, args.predictor)
    n = args.side
    full = run_plane(libs[0], (1, n, n), args.predictor, 10)
    bands = full["bands"]
    span = bands[:, 4] - bands[:, 3]
    t0 = bands[:, 3].min()
    clock = float(np.median(full["sm_clock_mhz"]))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "predictor": args.predictor,
        "plane": [1, n, n], "kernel_us": full["kernel_us"],
        "sm_clock_mhz": clock, "sm_clock_samples": full["sm_clock_mhz"][:6],
        "step_cycles": step["step_cycles"],
        "loaded_step_cycles": float(bands[:, 0].sum()
                                    / max(1, bands[:, 1].sum())),
        "register_step_cycles": step["register_step_cycles"],
        "kernel_cycles_from_probe": int(bands[:, 4].max() - t0),
        "band_span_cycles_mean": float(span.mean()),
        "compute_share": float(bands[:, 0].sum() / span.sum()),
        "wait_share": float(bands[:, 2].sum() / span.sum()),
        "take_above_share": float(bands[:, 5].sum() / span.sum()),
        "cp_async_wait_share": float(bands[:, 6].sum() / span.sum()),
        "store_share": float(bands[:, 7].sum() / span.sum()),
        "hand_down_share_lane31": float(bands[:, 8].sum() / span.sum()),
        "band_starts_cycles": [int(v) for v in bands[::8, 3] - t0],
        "chain_steps": 2 * n - 1,
        "chain_bound_us": (2 * n - 1) * step["step_cycles"] / clock,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

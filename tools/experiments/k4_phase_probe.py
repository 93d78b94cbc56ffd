#!/usr/bin/env python
"""Where kernel K4's time goes, on a CUDA card: cycles per phase.

    python tools/experiments/k4_phase_probe.py

K4 (jpeg_decoder_tpu_torch/csrc/fused_recon.cu) runs, in each warp, a
stream of 32-block tiles: wait for the tile's coefficients, K2's split-TF32
product, the raster epilogue, a barrier of the warp's group, color and
stores. This probe builds the kernel twice more with nvcc, as it ships and
with K4_PHASE_PROBE defined (clock64 around each phase in every warp),
runs both on the seeded 3 x [210, 256, 64] stores of
tools/experiments/fused_recon_probe_torch.py (the 3.44 Mpix 4:4:4 shape,
with small_444's tables), checks each output bit-equal to the unfused K2
path (`fused_recon_plain(..., k2=dequant_idct)`), and prints one JSON line:
each build's device time by kernel name (torch.profiler, 50 warm calls),
and from the probe build the cycles one warp spends per tile in each
phase, its prologue, the longest warp's span, the product's cycles per
mma.sync per SM sub-partition, and the SM clock nvidia-smi reads while it
runs; beside them the floor of that rate, `mma_floor_cycles`: cycles per
`mma.sync.m16n8k8` TF32 per sub-partition when 12 warps an SM (3 a
sub-partition, K4's shape) issue nothing else, 16 independent
accumulators each, on every SM.

Needs nvcc and a CUDA device; fails without them.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import threading
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "k4_probe"
SRC = ROOT / "jpeg_decoder_tpu_torch" / "csrc" / "fused_recon.cu"
BUILDS = {"shipped": [], "probe": ["-DK4_PHASE_PROBE"]}
PHASES = ("wait_and_prefetch", "product", "raster", "raster_barrier",
          "color", "prologue")
TILE_BLOCKS = 32          # a tile, per component

FLOOR_CU = r"""
#include "idct_mma.cuh"
__device__ long long mma_cycles;
__global__ void __launch_bounds__(384, 1) mma_floor(int iters, float* sink) {
  float acc[16][4] = {};
  const uint32_t a[4] = {__float_as_uint(1.0f), __float_as_uint(0.5f),
                         __float_as_uint(0.25f), __float_as_uint(2.0f)};
  const uint32_t b0 = __float_as_uint(0.125f), b1 = __float_as_uint(-1.0f);
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 16; ++j) jdt_idct::mma_tf32(acc[j], a, b0, b1);
  const long long t = clock64() - t0;
  if (threadIdx.x == 0 && blockIdx.x == 0) mma_cycles = t;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) s += acc[j][0] + acc[j][3];
  if (s == 1.2345f) sink[0] = s;
}
extern "C" double mma_floor_cycles(int iters, int sms) {
  float* sink;
  cudaMalloc(&sink, 4);
  long long c = 0;
  for (int rep = 0; rep < 2; ++rep) {
    mma_floor<<<sms, 384>>>(iters, sink);
    cudaDeviceSynchronize();
  }
  cudaMemcpyFromSymbol(&c, mma_cycles, sizeof(c));
  cudaFree(sink);
  return static_cast<double>(c) / (3.0 * 16 * iters);
}
"""


def build() -> dict:
    """Compile every build in parallel; return the libraries, argtypes
    set."""
    from jpeg_decoder_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-o",
         str(OUT / f"{name}.so"), str(SRC)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, flags in BUILDS.items()}
    (OUT / "floor.cu").write_text(FLOOR_CU)
    procs["floor"] = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(SRC.parent), "-shared",
         "-o", str(OUT / "floor.so"), str(OUT / "floor.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        _out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err[-4000:]}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        if name == "floor":
            lib.mma_floor_cycles.argtypes = [i, i]
            lib.mma_floor_cycles.restype = ctypes.c_double
            libs[name] = lib
            continue
        lib.jdt_fused_recon.argtypes = [p, p, p, p, i, i, i, p, p]
        if name == "probe":
            lib.jdt_k4_probe_read.argtypes = [p]
        libs[name] = lib
    return libs


def sm_clocks(busy) -> list:
    """SM clock samples (MHz) from nvidia-smi while `busy` keeps the card
    working."""
    clocks = []

    def query():    # nvidia-smi takes ~0.1 s to answer
        for _ in range(3):
            res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=60)
            clocks.extend(int(v) for v in res.stdout.split() if v.isdigit())

    smi = threading.Thread(target=query)
    smi.start()
    while smi.is_alive():
        busy()
        torch.cuda.synchronize()
    smi.join()
    return clocks


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from tools.experiments import fused_recon_probe_torch as k4_probe
    from tools.torch_port_profile import kernel_device_us
    from jpeg_decoder_tpu_torch.ops.kernels import (dequant_idct,
                                                    fused_recon_bases,
                                                    fused_recon_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build()
    floor = libs.pop("floor")
    qts = k4_probe.image_stores(k4_probe.DEFAULT_IMAGE.read_bytes())[1]
    bh, bw = k4_probe.LARGE_BLOCKS
    args = k4_probe.case_args(k4_probe.seeded_stores(0), qts, bw * 8)
    y, cb, cr, q, basis, width = args
    bases = fused_recon_bases(q, basis)
    want = fused_recon_plain(*args, k2=dequant_idct)
    out = torch.empty_like(want)
    res = {"device": torch.cuda.get_device_name(0),
           "shape": [3, bh, bw, 64], "width": width}
    for name, lib in libs.items():
        def call(lib=lib):
            err = lib.jdt_fused_recon(
                y.data_ptr(), cb.data_ptr(), cr.data_ptr(), bases.data_ptr(),
                bh, bw, width, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{name}: cudaError {err}")

        out.zero_()
        call()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{name} differs from the K2 path")
        res[f"{name}_kernel_us"] = kernel_device_us(
            call, "fused_recon_kernel", iters=50)["kernel_us"]
        if name != "probe":
            continue
        lib.jdt_k4_probe_reset()
        call()
        torch.cuda.synchronize()
        counters = (ctypes.c_ulonglong * 8)()
        if lib.jdt_k4_probe_read(ctypes.addressof(counters)) != 0:
            raise RuntimeError("reading the probe's counters failed")
        warps = counters[6]
        # Tiles per warp: each warp takes one 32-block run per tile.
        tiles = 3 * bh * -(-bw // TILE_BLOCKS) / warps
        per_tile = {k: counters[j] / warps / tiles
                    for j, k in enumerate(PHASES[:5])}
        # Every SM sub-partition holds 3 of the 12 warps; a tile's product
        # is 2 m16 tiles x 8 n-tiles x 8 k-steps x 2 TF32 products.
        res.update(warps=warps, tiles_per_warp=tiles,
                   cycles_per_warp_and_tile=per_tile,
                   prologue_cycles=counters[5] / warps,
                   longest_warp_cycles=counters[7],
                   product_cycles_per_mma_per_subpartition=(
                       per_tile["product"] / (3 * 2 * 8 * 8 * 2)),
                   sm_clock_mhz=sm_clocks(call)[:6])
    res["mma_floor_cycles"] = floor.mma_floor_cycles(
        20000, torch.cuda.get_device_properties(0).multi_processor_count)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

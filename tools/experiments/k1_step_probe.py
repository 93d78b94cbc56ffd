#!/usr/bin/env python
"""Where kernel K1's time goes, on a CUDA card: cycles per warp step.

    python tools/experiments/k1_step_probe.py [fixture ...]

K1 (jpeg_decoder_tpu_torch/csrc/huffman_decode.cu) walks each chunk of a
scan in one thread, the 32 chunks of a CTA in one warp, keeping the
decoder state every few steps, then decodes the segments between those
checkpoints in parallel. The walk is serial, so its time is the longest
chunk's symbol steps times the cycles of one warp step. This probe builds
the kernel with K1_STEP_PROBE defined (clock64 around the table staging,
the walk and the segment decode of every CTA), runs it on the fixtures'
delta wires (default large_420 and tower_420), and prints per fixture the
kernel time (CUDA events, mean of 5000 launches), the SM clock nvidia-smi
reads meanwhile, the most cycles of each phase over the CTAs, the most
symbols a chunk holds and the walk's cycles per symbol.

For scale it also times a bare bit-reader loop, the floor of one symbol
step on this card: a funnel-shift window, a shared-memory table load, the
bit position advanced by the entry, and a refill word from global memory.

Needs nvcc and a CUDA device; fails without them.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"
OUT = ROOT / "build" / "k1_probe"

FLOOR_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>
__device__ long long floor_cycles;
__global__ void floor_loop(const uint32_t* __restrict__ words,
                           const uint32_t* __restrict__ table, int steps,
                           uint32_t* sink) {
  __shared__ uint32_t s_table[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x) s_table[i] = table[i];
  __syncthreads();
  uint32_t w0 = words[0], w1 = words[1], w2 = words[2], widx = 2, b = 0;
  uint32_t acc = 0;
  const long long t0 = clock64();
  for (int t = 0; t < steps; ++t) {
    const uint32_t win = __funnelshift_l(w1, w0, b);
    const uint32_t used = (s_table[win >> 21] & 15) + 1;
    acc += used;
    b += used;
    if (b >= 32) {
      b -= 32; w0 = w1; w1 = w2; ++widx;
      w2 = __ldg(words + (widx & 0xFFFFF));
    }
  }
  if (threadIdx.x == 0) floor_cycles = clock64() - t0;
  if (acc == 0x12345u) sink[0] = acc;
}
extern "C" double floor_cycles_per_step(int steps) {
  uint32_t *words, *table, *sink;
  cudaMalloc(&words, 4 << 20); cudaMalloc(&table, 2048 * 4);
  cudaMalloc(&sink, 4);
  cudaMemset(words, 0x5a, 4 << 20); cudaMemset(table, 0x03, 2048 * 4);
  long long c = 0;
  for (int rep = 0; rep < 2; ++rep) {
    floor_loop<<<1, 32>>>(words, table, steps, sink);
    cudaDeviceSynchronize();
  }
  cudaMemcpyFromSymbol(&c, floor_cycles, sizeof(c));
  cudaFree(words); cudaFree(table); cudaFree(sink);
  return static_cast<double>(c) / steps;
}
"""


def nvcc(src: Path, out: Path, *flags: str) -> None:
    from jpeg_decoder_tpu_torch import _build

    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    *flags, "-o", str(out), str(src)], check=True)


def probe(lib, name: str) -> dict:
    from jpeg_decoder_tpu_torch import stage_host_bits
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import unpack_delta
    from jpeg_decoder_tpu_torch.params import DeviceParams

    dev = torch.device("cuda")
    (st,) = stage_host_bits((FIXTURES / name).read_bytes()).scans
    words = torch.from_numpy(st.words).to(dev)
    dm = torch.from_numpy(st.dm).to(dev)
    ab, base = unpack_delta(dm)
    tb = DeviceParams(dev).tables(st.scan)
    n_blocks = st.scan.plan.n_blocks
    nat = torch.empty((n_blocks, 64), dtype=torch.int16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        return lib.jdt_huffman_decode(
            words.data_ptr(), words.numel(), dm.data_ptr(), ab.data_ptr(),
            base.data_ptr(), dm.numel(), tb.maxcode.data_ptr(),
            tb.delta.data_ptr(), tb.values.data_ptr(), tb.lut.data_ptr(),
            tb.walk.data_ptr(), tb.n_tab, tb.pattern.data_ptr(),
            tb.pattern.numel(),
            tb.unzig.data_ptr(), st.s_max, nat.data_ptr(), n_blocks, stream)

    for _ in range(20):
        if run() != 0:
            raise RuntimeError("K1 launch failed")
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                            "--format=csv,noheader", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5000):
        run()
    stop.record()
    stop.synchronize()
    smi.terminate()
    clocks = smi.communicate()[0].split("\n")
    cycles = np.zeros(3 * 65536, np.int64)
    steps = np.zeros(65536, np.int32)
    if lib.jdt_k1_probe_read(cycles.ctypes.data, steps.ctypes.data) != 0:
        raise RuntimeError("reading the probe's counters failed")
    n = min(int(dm.numel()), 65536)
    staging, walk, decode = (cycles[q:3 * n:3] for q in range(3))
    return {"fixture": name, "chunks": int((steps[:n] > 0).sum()),
            "kernel_us": start.elapsed_time(stop) / 5000 * 1e3,
            "sm_clock": [c for c in clocks if c][:4],
            "max_staging_cycles": int(staging.max()),
            "max_walk_cycles": int(walk.max()),
            "max_decode_cycles": int(decode.max()),
            "max_symbols": int(steps[:n].max()),
            "walk_cycles_per_symbol":
                float(walk.max() / steps[:n].max()),
            "device": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) \
        or ["large_420.jpg", "tower_420.jpg"]
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    src = ROOT / "jpeg_decoder_tpu_torch" / "csrc" / "huffman_decode.cu"
    nvcc(src, OUT / "k1_probe.so", "-DK1_STEP_PROBE")
    (OUT / "floor.cu").write_text(FLOOR_CU)
    nvcc(OUT / "floor.cu", OUT / "floor.so")
    lib = ctypes.CDLL(str(OUT / "k1_probe.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.jdt_huffman_decode.argtypes = [p, i, p, p, p, i, p, p, p, p, p, i, p,
                                       i, p, i, p, i, p]
    lib.jdt_k1_probe_read.argtypes = [p, p]
    for name in names:
        print(json.dumps(probe(lib, name)))
    floor = ctypes.CDLL(str(OUT / "floor.so"))
    floor.floor_cycles_per_step.argtypes = [i]
    floor.floor_cycles_per_step.restype = ctypes.c_double
    print(json.dumps({"bare_bit_reader_cycles_per_step":
                      floor.floor_cycles_per_step(1000)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

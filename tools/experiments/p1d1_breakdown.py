#!/usr/bin/env python
"""Where kernel P1's (the prefix rebuild's) and D1's (a stripe's DC
totals') time goes on a card: each kernel as built, and builds of its
source with one change.

    python tools/experiments/p1d1_breakdown.py [P1] [D1]

(both kernels when none is named). Builds `jpeg_decoder_tpu_torch/csrc/
prefix_rebuild.cu` and `csrc/dc_totals.cu` with nvcc once per change, one
nvcc a build, all started together (copies under build/p1d1_breakdown/,
the checkout's sources untouched):
- P1 "256-row tiles", "64-row tiles": the base pass's tile resized;
- P1 "one launch", "one launch, 256-row tiles": the two passes in one
  cooperative launch (the base pass, one grid barrier, then the residuals
  grid-strided by the same CTAs, each thread's first entry loaded at the
  kernel's start; a CTA a tile, every CTA resident at once), with 128-
  and with 256-row tiles;
- P1 "residuals by CAS": the 16-bit add by an atomicCAS loop on its
  32-bit word that changes only its half (the first guess of the word
  read past L1) in place of the 32-bit adds and their carry correction;
- P1 "staging unrolled": the loop that stages a tile's slots left to the
  compiler to unroll;
- P1 "stores only": no tile is loaded and no slot staged: the staged rows
  stay zeros and are stored (the residual pass as built): the floor of
  the base pass's stores;
- P1 "empty (the launch floors)": both kernels' bodies taken out,
  launched as P1 launches them;
- D1 "ticket, accumulators": each CTA adds its sums into the accumulators
  (64-bit atomics, then a fence), takes a ticket, and the last CTA moves
  the accumulators to `out`; "ticket, partials": each CTA stores its sums
  past L1 and the last CTA by ticket adds them, a warp per (image,
  component) (the tail D1 first had); both in place of the arrival counts in
  the accumulators;
- D1 "warp sums by shuffles": five `__shfl_xor_sync` a component in place
  of `__reduce_add_sync`;
- D1 "128 threads", "512 threads": CTAs of 128 or 512 blocks (162 or 41
  CTAs on a large_420 stripe at 4);
- D1 "no atomics": the loads and the CTA's sums alone (wrong totals; the
  difference to "as built" is the atomic round);
- D1 "empty (the launch floor)": the kernel's body taken out, launched as
  D1 launches it.
Each build's C entries are bound in place of the library's and timed by
torch.profiler (tools/torch_port_profile.py::kernel_device_us, 100 warm
calls, the median, least and largest launch and the device time of all a
call enqueues; and the span of a call on the card, the gaps between its
launches included, `card_span_us` there): P1 on large_420's prefix wire
(80,640 blocks, 44,032 residual entries) and a prefix group of 16
tower_420 (98,304 blocks), D1 on seeded nat of one image of large_420's
stripe plans at 4 and 8; each build that computes its kernel's function
is also held to the plain version on each case ("equal"). Prints one JSON
line per build with ptxas's register counts (or the build's error), then
the card's name and power limit. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from tools.experiments.a1_breakdown import _try, build  # noqa: E402

P1_RESIDUALS_IN_THE_GRID = r"""  if (a.n == 0) return;
  cooperative_groups::this_grid().sync();
  unsigned* words = reinterpret_cast<unsigned*>(a.out);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  while (i < a.n) {
    add_residual(words, k, v, a.blocks * 64);
    i += stride;
    if (i < a.n) {
      k = a.idx[i];
      v = a.vals[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
prefix_resid_kernel"""
# One cooperative launch: the base pass, one grid barrier, then the
# residuals grid-strided by the same CTAs, each thread's first entry
# loaded at the kernel's start.
P1_ONE_LAUNCH = [
    (r"#include <cuda_runtime.h>\n",
     "#include <cuda_runtime.h>\n#include <cooperative_groups.h>\n"),
    (r"(prefix_base_kernel\(const __grid_constant__ Args a\) \{\n"
     r"  __shared__ Smem sm;\n  const int tid = threadIdx.x;\n)",
     "\\1  long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;"
     "\n  long long k = 0;\n  int v = 0;\n  if (i < a.n) {\n"
     "    k = a.idx[i];\n    v = a.vals[i];\n  }\n"),
    (r"(    __stwb\(out \+ q, rows\[q\]\);\n)\}\n\n__global__ void "
     r"__launch_bounds__\(kThreads\)\nprefix_resid_kernel",
     lambda m: m[1] + P1_RESIDUALS_IN_THE_GRID),
    (r"(?s)  prefix_base_kernel<<<.*?prefix_resid_kernel<<<.*?>>>\(a\);\n",
     "  void* args[] = {&a};\n"
     "  const cudaError_t launch = cudaLaunchCooperativeKernel(\n"
     "      reinterpret_cast<const void*>(prefix_base_kernel),\n"
     "      dim3(static_cast<unsigned>(tiles)), dim3(kThreads), args, 0,\n"
     "      static_cast<cudaStream_t>(stream));\n"
     "  if (launch != cudaSuccess) {\n"
     "    cudaGetLastError();\n"
     "    return static_cast<int>(launch);\n"
     "  }\n")]


def _rows(n: int) -> list:
    return [(r"constexpr int kRows = 128;", f"constexpr int kRows = {n};")]


# The residual add by an atomicCAS loop on the 32-bit word that changes
# only the element's half (the first guess of the word read past L1), in
# place of the 32-bit adds and their carry correction.
P1_CAS = [(r"(?s)  if \(k & 1\) \{\n    atomicAdd\(word, add << 16\);.*?"
           r"atomicAdd\(word, 0xffff0000u\);\n", r"""
  const int shift = static_cast<int>(k & 1) * 16;
  const uint32_t mask = 0xffffu << shift;
  unsigned old = __ldcg(word);
  unsigned assumed;
  do {
    assumed = old;
    const uint32_t half = ((assumed >> shift) + add) & 0xffffu;
    old = atomicCAS(word, assumed, (assumed & ~mask) | (half << shift));
  } while (old != assumed);
"""[1:])]
# name: (edits, whether the output is P1's)
P1_EDITS = {
    "as built": ([], True),
    "256-row tiles": (_rows(256), True),
    "64-row tiles": (_rows(64), True),
    "one launch": (P1_ONE_LAUNCH, True),
    "one launch, 256-row tiles": (P1_ONE_LAUNCH + _rows(256), True),
    "residuals by CAS": (P1_CAS, True),
    "staging unrolled": ([(r"  // Not unrolled:.*\n.*\n#pragma unroll 1\n",
                           "")], True),
    "stores only": ([(r"  load_tile\(a, t, cnt, sm, tid\);\n", ""),
                     (r"(?s)  for \(int row = tid / kPrefix;.*?;\n", "")],
                    False),
    "empty (the launch floors)": (
        [(r"(?s)(prefix_base_kernel\(const __grid_constant__ Args a\) "
          r"\{\n).*?\n\}\n\n__global__", "\\1}\n\n__global__"),
         (r"(?s)(prefix_resid_kernel\(const __grid_constant__ Args a\) "
          r"\{\n).*?\n\}\n\n\}  // namespace",
          "\\1}\n\n}  // namespace")], False),
}

# The tail from "if (tid >= a.ncomp) return;" to the kernel's end, in
# the two designs with a ticket that D1 was measured against.
D1_TICKET_ACCUMULATORS = r"""  if (tid < a.ncomp) {
    long long t = 0;
    for (int w = 0; w < kWarps; ++w) t += sm.warp[w][tid];
    atomicAdd(a.acc + img * a.ncomp + tid,
              static_cast<unsigned long long>(t));
    __threadfence();
  }
  __syncthreads();
  __shared__ int last;
  unsigned* counter = reinterpret_cast<unsigned*>(a.acc - 1);
  if (tid == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long cells = gridDim.x / a.ctas_per_image * a.ncomp;
  for (long long p = tid; p < cells; p += kThreads)
    a.out[p] = static_cast<long long>(atomicExch(a.acc + p, 0ull));
  if (tid == 0) atomicExch(counter, 0u);
}
"""
D1_TICKET_PARTIALS = r"""  if (tid < a.ncomp) {
    long long t = 0;
    for (int w = 0; w < kWarps; ++w) t += sm.warp[w][tid];
    __stcg(reinterpret_cast<long long*>(a.acc)
           + static_cast<long long>(blockIdx.x) * a.ncomp + tid, t);
    __threadfence();
  }
  __syncthreads();
  __shared__ int last;
  unsigned* counter = reinterpret_cast<unsigned*>(a.acc - 1);
  if (tid == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long cells = gridDim.x / a.ctas_per_image * a.ncomp;
  for (long long p = warp; p < cells; p += kWarps) {
    const long long i = p / a.ncomp;
    const int c = static_cast<int>(p - i * a.ncomp);
    long long t = 0;
    for (long long k = lane; k < a.ctas_per_image; k += 32)
      t += __ldcg(reinterpret_cast<const long long*>(a.acc)
                  + (i * a.ctas_per_image + k) * a.ncomp + c);
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
    if (lane == 0) a.out[p] = t;
  }
  if (tid == 0) atomicExch(counter, 0u);
}
"""
D1_TAIL = (r"(?s)  if \(tid >= a\.ncomp\) return;\n.*?\n\}\n"
           r"(?=\n\}  // namespace)")
# The partials need a word per (CTA, component): the launch's check asks
# for them (the buffer's least size, 4,096 words, holds them for these
# cases).
D1_PARTIAL_WORDS = (
    r"jdt_dc_totals_status_words\(images, ncomp\) > status_words",
    "ctas * ncomp > status_words")
# name: (edits, whether the output is D1's)
D1_EDITS = {
    "as built": ([], True),
    "ticket, accumulators": ([(D1_TAIL, D1_TICKET_ACCUMULATORS)], True),
    "ticket, partials": ([(D1_TAIL, D1_TICKET_PARTIALS), D1_PARTIAL_WORDS],
                         True),
    "warp sums by shuffles": (
        [(r"    const int s = __reduce_add_sync\(kFull, comp == c \? v : 0\);"
          r"\n",
          "    int s = comp == c ? v : 0;\n"
          "    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, "
          "s, o);\n")], True),
    "128 threads": ([(r"constexpr int kThreads = 256;",
                      "constexpr int kThreads = 128;")], True),
    "512 threads": ([(r"constexpr int kThreads = 256;",
                      "constexpr int kThreads = 512;")], True),
    "no atomics": ([(D1_TAIL, "  if (tid < a.ncomp && sm.warp[0][tid] == "
                     "12345) a.out[tid] = 0;\n}\n")], False),
    "empty (the launch floor)": (
        [(r"(?s)(dc_totals_kernel\(const __grid_constant__ Args a\) \{\n)"
          r".*?\n\}\n\n\}  // namespace", "\\1}\n\n}  // namespace")],
        False),
}


def timed(fn, symbol: str) -> dict:
    from tools.torch_port_profile import card_span_us, kernel_device_us

    prof = kernel_device_us(fn, symbol, iters=100)
    each = sorted(prof["each_us"])
    return {"median_us": each[len(each) // 2], "min_us": each[0],
            "max_us": each[-1], "launches": prof["launches"],
            "call_device_us": prof["all_device_us"],
            "call_launches": prof["all_launches"], **card_span_us(fn)}


def p1_cases(dev) -> dict:
    """(geometry, wire on the card) of large_420's prefix wire and of a
    prefix group of 16 tower_420, as the stream merges it."""
    import jpeg_decoder_tpu_torch as jt
    from jpeg_decoder_tpu_torch.host.staging import stage_host
    from torch_inputs import fixture

    st = stage_host(fixture("large_420.jpg"))
    cases = {"large_420": (st.geometry, [
        torch.from_numpy(a).to(dev)
        for a in (st.dc, st.ac, st.resid_idx, st.resid_vals)])}
    with jt.DeviceStreamDecoder(device=dev, host_threads=1,
                                interchange="prefix") as dec:
        one = dec.stage(fixture("tower_420.jpg"))
        cases["tower_420 x16"] = (one.geometry,
                                  dec._group_wires("prefix", [one] * 16))
    return cases


def d1_cases(dev) -> dict:
    """(seeded nat of one image, plan) of large_420's stripe plans at 4
    and 8."""
    import jpeg_decoder_tpu_torch as jt
    from jpeg_decoder_tpu_torch.parallel.stripe_bits import (
        split_anchored_stripes)
    from torch_inputs import fixture

    scan = jt.stage_host_bits(fixture("large_420.jpg")).scans[0].scan
    cases = {}
    for n in (4, 8):
        plan = split_anchored_stripes(scan, n).plan
        nat = np.random.default_rng(n).integers(
            -32768, 32768, (1, plan.n_blocks, 64), dtype=np.int16)
        cases[f"large_420 stripe at {n}"] = (torch.from_numpy(nat).to(dev),
                                             plan)
    return cases


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kernels = set(argv) or {"P1", "D1"}
    if not torch.cuda.is_available() or not kernels <= {"P1", "D1"}:
        print("usage: p1d1_breakdown.py [P1] [D1] (needs a CUDA device)",
              file=sys.stderr)
        return 1
    from jpeg_decoder_tpu_torch import _build
    from jpeg_decoder_tpu_torch.entropy.assemble import (dc_totals,
                                                         dc_totals_plain)
    from jpeg_decoder_tpu_torch.entropy.prefix import (prefix_stores,
                                                       prefix_stores_plain)

    lib = _build.load()
    dev = torch.device("cuda")
    p1 = p1_cases(dev)
    d1 = d1_cases(dev)
    p1_want = {k: prefix_stores_plain(g, *w) for k, (g, w) in p1.items()}
    d1_want = {k: dc_totals_plain(*c) for k, c in d1.items()}
    out_dir = ROOT / "build" / "p1d1_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    for kernel, edits_of, entries, symbol, source in (
            ("P1", P1_EDITS, ("jdt_prefix_rebuild",), "prefix_",
             "prefix_rebuild.cu"),
            ("D1", D1_EDITS, ("jdt_dc_totals", "jdt_dc_totals_status_words"),
             "dc_totals_kernel", "dc_totals.cu")):
        if kernel not in kernels:
            continue
        originals = [getattr(lib, e) for e in entries]
        src = (ROOT / "jpeg_decoder_tpu_torch" / "csrc" / source).read_text()
        outs = [out_dir / f"{kernel.lower()}_{i}.so"
                for i in range(len(edits_of))]
        with ThreadPoolExecutor(8) as pool:     # one nvcc a build, together
            built = list(pool.map(
                lambda e: _try(build, e[0][0], src, e[1]),
                zip(edits_of.values(), outs)))
        for (name, (_edits, checked)), out, regs in zip(
                edits_of.items(), outs, built):
            row = {"kernel": kernel, "build": name}
            if isinstance(regs, str):
                print(json.dumps({**row, "error": regs}), flush=True)
                continue
            built_lib = ctypes.CDLL(str(out))
            for entry, original in zip(entries, originals):
                fn = getattr(built_lib, entry)
                fn.argtypes, fn.restype = original.argtypes, original.restype
                setattr(lib, entry, fn)
            _build._status.clear()      # each build's status words anew
            row["registers"] = regs
            try:
                if kernel == "P1":
                    for label, (geometry, wire) in p1.items():
                        def call(g=geometry, w=wire):
                            return prefix_stores(g, *w)
                        row[label] = timed(call, symbol)
                        if checked:
                            row[label]["equal"] = all(
                                torch.equal(g, w)
                                for g, w in zip(call(), p1_want[label]))
                else:
                    for label, (nat, plan) in d1.items():
                        def call(n=nat, p=plan):
                            return dc_totals(n, p)
                        row[label] = timed(call, symbol)
                        if checked:
                            row[label]["equal"] = torch.equal(
                                call(), d1_want[label])
            except RuntimeError as exc:
                row["error"] = str(exc)[-500:]
            print(json.dumps(row), flush=True)
        for entry, original in zip(entries, originals):
            setattr(lib, entry, original)
        _build._status.clear()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Where kernel A1's (the assembly's) and U1's (the delta unpack's) time
goes on a card: each kernel as built, and builds of its source with one
edit.

    python tools/experiments/a1_breakdown.py [A1] [U1]

(both kernels when none is named). Builds `jpeg_decoder_tpu_torch/csrc/
assemble.cu` and `csrc/unpack_delta.cu` with nvcc once per edit, one nvcc
a build, all started together (made on copies under build/a1_breakdown/,
the checkout's sources untouched):
- A1 "no look-back": a tile takes 0 for the prefix of its predecessors
  (its DC comes out wrong); the tickets, loads, the tile's own scan, its
  status stores and the stores of the rows stay. The difference to "as
  built" is what waiting on the predecessors costs;
- A1 "no prefix": no status is published or read, and the DC column is
  stored as it was loaded; the tickets, the loads, the tile's own scan
  and the stores stay: nearly a copy kernel in A1's own tiling;
- A1 "128-row tiles": kRows = kThreads = 128 (twice the tiles, half the
  rows in flight a CTA);
- A1 "2 CTAs/SM", "4 CTAs/SM": `__launch_bounds__(kThreads, 2 or 4)`
  instead of 3 (the registers a thread may take: 128 or 64, not 85);
- U1 "no look-back": a tile takes 0 for the prefixes of its predecessors
  (wrong past the first tile); the tickets, loads, the tile's scan, its
  status stores and the stores stay; "no status at all": no status word
  is stored or read either (the tickets stay); "acquire/release status
  words": the status words stored with release and loaded with acquire
  semantics, as A1 does, instead of relaxed; "tiles by blockIdx" (with
  and without the look-back): the tile is the CTA's blockIdx, not a
  ticket (timing only: right only while every CTA is resident at once);
- U1 "bulk load": the tile's words come in by cp.async.bulk (one
  128-byte row a copy onto an mbarrier) instead of 16-byte loads;
- U1 tile shapes beside the built 256 x 32: kThreads x kPer of 256 x 8,
  512 x 4, 256 x 16, 512 x 8, 1024 x 4, 512 x 16 and 1024 x 8, tiles of
  2,048 to 8,192 entries (the wrapper's `U1_TILE` set to match for the
  build's calls);
- U1 "empty (the launch floor)": the kernel's body taken out, launched as
  U1 launches it.
Each build's C entry is bound in place of the library's and timed by
torch.profiler (tools/torch_port_profile.py::kernel_device_us, 100 warm
calls, the median launch): A1 on K1's nat of large_420 (2048 x 1680
4:2:0, 80,640 blocks) and of 16 tower_420 images in one call, U1 on
large_420's wire (6,144 entries), the merged wires of 16 tower_420 and
16 large_420 images, and seeded wires of 65,536 and 1,048,576 entries;
each U1 build that computes U1 is also held to `unpack_delta_plain` on
each wire ("equal"). Beside them, the device time of `Tensor.copy_` of
large_420's nat (10.32 MB each way), the copy rate any kernel moving those
bytes meets. Prints one JSON line per build with ptxas's register counts
(or the build's error: an edit whose regular expression no longer matches
the source, or nvcc's refusal), then the card's name and power limit.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

LOOK = (r"excl = look_back\(a.status, ticket - 1, ticket - t, a.epoch, "
        r"lane\);", "excl = 0;")
A1_EDITS = {
    "as built": [],
    "no look-back": [LOOK],
    "no prefix": [(r"if \(tid < cnt\) sm.dc\[tid\] = \(flag \? val : "
                 r"sm.excl \+ val\) & 0xffffu;", ""),
                (r"  if \(warp == 0\) \{\n    const uint32_t agg",
                 "  if (a.n_blocks < 0) {\n    const uint32_t agg")],
    "128-row tiles": [(r"constexpr int kThreads = 256;",
                       "constexpr int kThreads = 128;"),
                      (r"constexpr int kRows = 256;",
                       "constexpr int kRows = 128;")],
    "2 CTAs/SM": [(r"__launch_bounds__\(kThreads, 3\)",
                   "__launch_bounds__(kThreads)")],
    "4 CTAs/SM": [(r"__launch_bounds__\(kThreads, 3\)",
                   "__launch_bounds__(kThreads, 4)")],
}


def _u1_shape(threads: int, per: int) -> list:
    return [(r"constexpr int kThreads = \d+;",
             f"constexpr int kThreads = {threads};"),
            (r"constexpr int kPer = \d+;", f"constexpr int kPer = {per};")]


# The launch floor: U1's kernel with its body taken out, launched as U1
# launches it (chip_smoke.py phase 25 times it too).
U1_EMPTY = [(r"(?s)(int vec\) \{\n).*?\n\}\n\n\}  // namespace",
             "\\1}\n\n}  // namespace")]
# The tile's words by cp.async.bulk, one 128-byte row (a padded row of
# shared memory) a copy, warp 0 issuing them onto one mbarrier, where the
# tile is whole and the wire on 16 bytes; the 16-byte loads otherwise.
U1_BULK_LOAD = r"""
  if (vec && cnt == kTile) {
    __shared__ alignas(8) unsigned long long bar;
    const unsigned bar_a =
        static_cast<unsigned>(__cvta_generic_to_shared(&bar));
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar_a));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (warp == 0) {
      if (lane == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
            :: "r"(bar_a), "r"(kTile * 4) : "memory");
      __syncwarp();
      for (int r = lane; r < kTile / 32; r += 32) {
        const unsigned dst = static_cast<unsigned>(
            __cvta_generic_to_shared(sm.buf + slot(32 * r)));
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
            "::bytes [%0], [%1], 128, [%2];"
            :: "r"(dst), "l"(dm + t0 + 32 * r), "r"(bar_a) : "memory");
      }
    }
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, "
          "[%1], 0; selp.u32 %0, 1, 0, p; }"
          : "=r"(done) : "r"(bar_a) : "memory");
  } else {
\1
  }
  uint32_t d[kPer]"""
# name: (edits, the tile in entries, whether the output is U1's)
U1_EDITS = {
    "as built": ([], None, True),
    "no look-back": ([(r"look_back\(status, static_cast<long long>\(tile\) "
                       r"- 1, epoch, lane,\s*pre_d, pre_b\);", "")], None,
                     False),
    "acquire/release status words": ([(r"ld\.relaxed\.gpu",
                                       "ld.acquire.gpu"),
                                      (r"st\.relaxed\.gpu",
                                       "st.release.gpu")], None, True),
    "tiles by blockIdx": ([(r"atomicAdd\(counter, 1u\)", "blockIdx.x")],
                          None, True),
    "no look-back, tiles by blockIdx": (
        [(r"atomicAdd\(counter, 1u\)", "blockIdx.x"),
         (r"look_back\(status, static_cast<long long>\(tile\) - 1, epoch, "
          r"lane,\s*pre_d, pre_b\);", "")], None, False),
    "no status at all": ([(r"(?s)    if \(tiles > 1\) \{\n      const "
                           r"uint32_t tot_d.*?\n    \}\n    if \(lane < "
                           r"kWarps\)", "    if (lane < kWarps)")], None,
                         False),
    "bulk load": ([(r"(?s)\n(#pragma unroll\n  for \(int k = 0; k < kVecs; "
                    r"\+\+k\) \{\n    const int i = 4 \* \(k \* kThreads "
                    r"\+ tid\);\n    uint4 x;.*?__syncthreads\(\);)\n  "
                    r"uint32_t d\[kPer\]", U1_BULK_LOAD)], None, True),
    **{f"{threads} threads x {per} ({threads * per}-entry tiles)": (
        _u1_shape(threads, per), threads * per, True)
       for threads, per in ((256, 8), (512, 4), (256, 16), (512, 8),
                            (1024, 4), (512, 16), (1024, 8))},
    "empty (the launch floor)": (U1_EMPTY, None, False),
}


def build(edits: list, src: str, out: Path) -> list:
    """nvcc the edited source into `out`; ptxas's register counts."""
    from jpeg_decoder_tpu_torch import _build

    for pattern, repl in edits:
        src, n = re.subn(pattern, repl, src)
        if n != 1:
            raise RuntimeError(f"{pattern!r} matched {n} times")
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", str(out), str(cu)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed\n{res.stderr[-3000:]}")
    return sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                              res.stderr)})


def timed(fn, symbol: str) -> dict:
    from tools.torch_port_profile import kernel_device_us

    each = sorted(kernel_device_us(fn, symbol, iters=100)["each_us"])
    return {"median_us": each[len(each) // 2], "min_us": each[0],
            "max_us": each[-1], "calls": len(each)}


def u1_wires(dev) -> dict:
    """The wires U1 is timed on: large_420's (6,144 entries), the merged
    wires of 16 tower_420 and 16 large_420 images (`merge_scans`, as
    `decode_stream(batch_size=16)` ships them), and seeded wires of 65,536
    and 1,048,576 entries."""
    import jpeg_decoder_tpu_torch as jt
    from jpeg_decoder_tpu_torch.models.stream import merge_scans
    from torch_inputs import fixture

    scans = {name: jt.stage_host_bits(fixture(name)).scans[0]
             for name in ("large_420.jpg", "tower_420.jpg")}
    wires = {"large_420": torch.from_numpy(scans["large_420.jpg"].dm)}
    for name in ("tower_420", "large_420"):
        (_words, dm), _s_max, _n = merge_scans([scans[f"{name}.jpg"]] * 16)
        wires[f"{name} x16"] = torch.from_numpy(dm)
    gen = torch.Generator().manual_seed(0)
    for n in (65536, 1 << 20):
        wires[f"seeded {n}"] = torch.randint(0, 1 << 20, (n,),
                                             dtype=torch.int32, generator=gen)
    return {k: v.to(dev) for k, v in wires.items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kernels = set(argv) or {"A1", "U1"}
    if not torch.cuda.is_available() or not kernels <= {"A1", "U1"}:
        print("usage: a1_breakdown.py [A1] [U1] (needs a CUDA device)",
              file=sys.stderr)
        return 1
    import jpeg_decoder_tpu_torch as jt
    from jpeg_decoder_tpu_torch import _build
    from jpeg_decoder_tpu_torch.entropy import chunk_decode
    from jpeg_decoder_tpu_torch.entropy.assemble import assemble_nat
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import (
        decode_chunks, unpack_delta, unpack_delta_plain)
    from jpeg_decoder_tpu_torch.params import DeviceParams
    from torch_inputs import fixture

    lib = _build.load()
    dev = torch.device("cuda")
    params = DeviceParams(dev)
    nats = {}
    for name in ("large_420.jpg", "tower_420.jpg"):
        (st,) = jt.stage_host_bits(fixture(name)).scans
        dm = torch.from_numpy(st.dm).to(dev)
        ab, base = unpack_delta(dm)
        nats[name] = (decode_chunks(torch.from_numpy(st.words).to(dev), dm,
                                    ab, base, params.tables(st.scan),
                                    st.s_max, st.scan.plan.n_blocks),
                      st.scan.plan)
    tower, tower_plan = nats.pop("tower_420.jpg")
    nats["tower_420 x16"] = (torch.stack([tower] * 16), tower_plan)
    wires = u1_wires(dev)
    want = {k: unpack_delta_plain(w.cpu()) for k, w in wires.items()}
    large = nats["large_420.jpg"][0]
    copy_out = torch.empty_like(large)
    print(json.dumps({"copy_ of large_420's nat": timed(
        lambda: copy_out.copy_(large), "")}), flush=True)
    out_dir = ROOT / "build" / "a1_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    tile0 = chunk_decode.U1_TILE
    for kernel, edits_of, entry, symbol, cases, call in (
            ("A1", {k: (v, None, False) for k, v in A1_EDITS.items()},
             "jdt_assemble", "assemble_kernel", nats,
             lambda case: (lambda: assemble_nat(*case))),
            ("U1", U1_EDITS, "jdt_unpack_delta", "unpack_delta_kernel",
             wires, lambda dm: (lambda: unpack_delta(dm)))):
        if kernel not in kernels:
            continue
        original = getattr(lib, entry)
        src = (ROOT / "jpeg_decoder_tpu_torch" / "csrc"
               / ("assemble.cu" if kernel == "A1" else "unpack_delta.cu")
               ).read_text()
        outs = [out_dir / f"{kernel.lower()}_{i}.so"
                for i in range(len(edits_of))]
        with ThreadPoolExecutor(8) as pool:     # one nvcc a build, together
            built = list(pool.map(
                lambda e: _try(build, e[0][0], src, e[1]),
                zip(edits_of.values(), outs)))
        for (name, (_edits, tile, checked)), out, regs in zip(
                edits_of.items(), outs, built):
            row = {"kernel": kernel, "build": name}
            if isinstance(regs, str):
                print(json.dumps({**row, "error": regs}), flush=True)
                continue
            fn = getattr(ctypes.CDLL(str(out)), entry)
            fn.argtypes, fn.restype = original.argtypes, original.restype
            setattr(lib, entry, fn)
            chunk_decode.U1_TILE = tile or tile0
            row["registers"] = regs
            try:
                for label, case in cases.items():
                    row[label] = timed(call(case), symbol)
                    if kernel == "U1" and checked:
                        row[label]["equal"] = all(
                            torch.equal(g.cpu(), w)
                            for g, w in zip(unpack_delta(case), want[label]))
            except RuntimeError as exc:
                row["error"] = str(exc)[-500:]
            print(json.dumps(row), flush=True)
        setattr(lib, entry, original)
        chunk_decode.U1_TILE = tile0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


def _try(fn, *args):
    """fn(*args), or its error's text."""
    try:
        return fn(*args)
    except RuntimeError as exc:
        return str(exc)[-2000:]


if __name__ == "__main__":
    sys.exit(main())

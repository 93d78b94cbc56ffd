#!/usr/bin/env python
"""Where kernel A1's (the assembly's) and U1's (the delta unpack's) time
goes on a card: each kernel as built, and builds of its source with one
edit.

    python tools/experiments/a1_breakdown.py

Builds `jpeg_decoder_tpu_torch/csrc/assemble.cu` and `csrc/unpack_delta.cu`
with nvcc once per edit (made on a copy under build/a1_breakdown/, the
checkout's sources untouched):
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
- U1 "2 entries a thread", "4 entries a thread": kPer = 2 and 4 instead of
  8 (rounds of 2,048 and 4,096 entries).
Each build's C entry is bound in place of the library's and timed by
torch.profiler (tools/torch_port_profile.py::kernel_device_us, 100 warm
calls, the median launch): A1 on K1's nat of large_420 (2048 x 1680
4:2:0, 80,640 blocks) and of 16 tower_420 images in one call, U1 on
large_420's wire (6,144 entries) and on seeded wires of 65,536 and
1,048,576 entries. Beside them, the device time of `Tensor.copy_` of
large_420's nat (10.32 MB each way), the copy rate any kernel moving those
bytes meets. Prints one JSON line per build with ptxas's register counts,
then the card's name and power limit. The edits are regular expressions
on the sources: the script fails if one no longer matches. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
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
U1_EDITS = {
    "as built": [],
    "2 entries a thread": [(r"constexpr int kPer = 8;",
                            "constexpr int kPer = 2;")],
    "4 entries a thread": [(r"constexpr int kPer = 8;",
                            "constexpr int kPer = 4;")],
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


def main() -> int:
    if not torch.cuda.is_available():
        print("a1_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    import jpeg_decoder_tpu_torch as jt
    from jpeg_decoder_tpu_torch import _build
    from jpeg_decoder_tpu_torch.entropy.assemble import assemble_nat
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import (decode_chunks,
                                                             unpack_delta)
    from jpeg_decoder_tpu_torch.params import DeviceParams
    from torch_inputs import fixture

    lib = _build.load()
    dev = torch.device("cuda")
    params = DeviceParams(dev)
    nats, wires = {}, {}
    for name in ("large_420.jpg", "tower_420.jpg"):
        (st,) = jt.stage_host_bits(fixture(name)).scans
        dm = torch.from_numpy(st.dm).to(dev)
        ab, base = unpack_delta(dm)
        nat = decode_chunks(torch.from_numpy(st.words).to(dev), dm, ab, base,
                            params.tables(st.scan), st.s_max,
                            st.scan.plan.n_blocks)
        nats[name] = (nat, st.scan.plan)
        wires[name] = dm
    tower, tower_plan = nats.pop("tower_420.jpg")
    nats["tower_420 x16"] = (torch.stack([tower] * 16), tower_plan)
    wires.pop("tower_420.jpg")
    gen = torch.Generator(device=dev).manual_seed(0)
    for n in (65536, 1 << 20):
        wires[f"seeded {n}"] = torch.randint(0, 1 << 20, (n,), device=dev,
                                             dtype=torch.int32, generator=gen)
    large = nats["large_420.jpg"][0]
    copy_out = torch.empty_like(large)
    print(json.dumps({"copy_ of large_420's nat": timed(
        lambda: copy_out.copy_(large), "")}), flush=True)
    out_dir = ROOT / "build" / "a1_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    for kernel, edits_of, entry, symbol, cases, call in (
            ("A1", A1_EDITS, "jdt_assemble", "assemble_kernel", nats,
             lambda case: (lambda: assemble_nat(*case))),
            ("U1", U1_EDITS, "jdt_unpack_delta", "unpack_delta_kernel",
             wires, lambda dm: (lambda: unpack_delta(dm)))):
        original = getattr(lib, entry)
        src = (ROOT / "jpeg_decoder_tpu_torch" / "csrc"
               / ("assemble.cu" if kernel == "A1" else "unpack_delta.cu")
               ).read_text()
        for i, (name, edits) in enumerate(edits_of.items()):
            out = out_dir / f"{kernel.lower()}_{i}.so"
            regs = build(edits, src, out)
            fn = getattr(ctypes.CDLL(str(out)), entry)
            fn.argtypes, fn.restype = original.argtypes, original.restype
            setattr(lib, entry, fn)
            row = {"kernel": kernel, "build": name, "registers": regs}
            for label, case in cases.items():
                row[label] = timed(call(case), symbol)
            print(json.dumps(row), flush=True)
        setattr(lib, entry, original)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

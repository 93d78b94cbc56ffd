#!/usr/bin/env python
"""Where kernel T1's time goes on a card: the kernel as built, and builds of
its source with one part taken out.

    python tools/experiments/t1_breakdown.py

Builds `jpeg_decoder_tpu_torch/csrc/interleaved_tail.cu` with nvcc four
more times, each with one edit to the kernel's body (made on a copy under
build/t1_breakdown/, the checkout's source untouched):
- "no compute": the runs' pixels are not computed (the output words hold
  one staged byte); the staging and the stores stay;
- "no loads": nothing is staged (the pixels come from whatever shared
  memory holds); the compute and the stores stay;
- "loads only": the staging stays, no pixel is computed or stored;
- "empty": neither; what is left is the launch, each component's plan
  and the two barriers.
Each build's `jdt_interleaved_tail` is bound in place of the library's and
timed by torch.profiler (tools/torch_port_profile.py::kernel_device_us, 100
warm calls, the median launch) on seeded block pixels of large_420's
geometry (2048 x 1680 4:2:0), 16 tower_420 images (512 x 512 4:2:0) in
one launch and a 4:4:4 image of large_420's size, interleaved. Prints one
JSON line per build with ptxas's register counts, then the card's name and
power limit. The edits are regular expressions on the source: the script
fails if one no longer matches. Needs a CUDA device and nvcc.
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

RUN = r"    if \(live\) run<L, P, N>\(a, tiles, smem\[0\], r \+ h, c, o\);"
STAGE = r"  stage\(segs, counts, N, smem\[0\], tid\);"
LIVE = r"    const bool live = r \+ h < a.out_h && c < a.out_w;"
LINES = r"  const bool lines = P && a.vec_rows && p.nc == kTW;"
EDITS = {
    "as built": [],
    "no compute": [(RUN, "    if (live) o[0] = smem[0][tid];")],
    "no loads": [(STAGE, "  if (a.out_w < 0) "
                  "stage(segs, counts, N, smem[0], tid);")],
    "loads only": [(RUN, "    if (live) o[0] = smem[0][tid];"),
                   (LIVE, "    const bool live = a.out_w < 0;"),
                   (LINES, "  const bool lines = false;")],
    "empty": [(STAGE, "  if (a.out_w < 0) "
               "stage(segs, counts, N, smem[0], tid);"),
              (RUN, "    if (live) o[0] = smem[0][tid];"),
              (LIVE, "    const bool live = a.out_w < 0;"),
              (LINES, "  const bool lines = false;")],
}


def build(name: str, src: str, out: Path) -> list:
    """nvcc the edited source into `out`; ptxas's register counts."""
    from jpeg_decoder_tpu_torch import _build

    for pattern, repl in EDITS[name]:
        src, n = re.subn(pattern, repl, src)
        if n != 1:
            raise RuntimeError(f"{name}: {pattern!r} matched {n} times")
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", str(out), str(cu)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stderr[-3000:]}")
    return sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                              res.stderr)})


def main() -> int:
    if not torch.cuda.is_available():
        print("t1_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    from jpeg_decoder_tpu_torch import _build
    from jpeg_decoder_tpu_torch.ops.kernels import interleaved_tail
    from tools.torch_port_profile import kernel_device_us
    from torch_inputs import t1_args, t1_geometry, t1_pixels

    lib = _build.load()
    original = lib.jdt_interleaved_tail
    dev = torch.device("cuda")
    cases = {}
    for label, layout, h, w, images in (
            ("large_420", "420", 1680, 2048, 1),
            ("tower_420 x16", "420", 512, 512, 16),
            ("444 2048x1680", "444", 1680, 2048, 1)):
        g = t1_geometry(layout, h, w, 8, "YCBCR")
        cases[label] = (t1_pixels(g, images, 0, dev), t1_args(g))
    src = (ROOT / "jpeg_decoder_tpu_torch" / "csrc"
           / "interleaved_tail.cu").read_text()
    out_dir = ROOT / "build" / "t1_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(EDITS):
        regs = build(name, src, out_dir / f"t1_{i}.so")
        fn = ctypes.CDLL(str(out_dir / f"t1_{i}.so")).jdt_interleaved_tail
        fn.argtypes, fn.restype = original.argtypes, original.restype
        lib.jdt_interleaved_tail = fn
        row = {"build": name, "registers": regs}
        for label, (px, args) in cases.items():
            t = kernel_device_us(lambda: interleaved_tail(px, *args),
                                 "interleaved_tail_kernel", iters=100)
            each = sorted(t["each_us"])
            row[label] = {"median_us": each[len(each) // 2],
                          "min_us": each[0], "max_us": each[-1],
                          "calls": len(each)}
        print(json.dumps(row), flush=True)
    lib.jdt_interleaved_tail = original
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Launches and device time of the port's main path, per image and per
layer, of one checkout, for A/B runs on a card.

    python tools/experiments/path_ab.py TREE

TREE is the root of a checkout of this repository (this one: `.`; another
commit: unpack it with `git archive COMMIT | tar -x -C DIR` into a directory
`.gitignore` lists). The script imports the port and its
`tools/torch_port_profile.py` from TREE and, on the fixtures of this
checkout, prints one JSON line per case with the profiler's numbers
(`profile`: 20 device-resident decodes after 3 warm ones, the wire already
on the card): kernel launches per image, device busy ms per image (the
union of kernel intervals), the idle share of that window, kernel ms per
image by layer (the decoder's record_function spans: unpack_delta,
k1_decode, assemble, reconstruct, interleaved_tail, ...; a replayed CUDA
graph's kernels, which no span holds, by their names) and the
device-resident ms per image by CUDA events (`device_resident_rate`, 50
decodes). Cases: large_420 (2048 x 1680 4:2:0) at fast and at exact, both
interleaved on the bits interchange; tower_420 (512 x 512 4:2:0) as a group
of 16 at fast; the same two at fast on the prefix interchange, with the
synchronising operations per image of the prefix route's device half
(`_run_device` under `torch.cuda.set_sync_debug_mode("warn")`, counted as
the warnings PyTorch raises); and large_420 striped over 4 and 8 slots of
the card (`decode_bits_striped`, exact: launches, device busy and
CUDA-event ms per stripe, by `kernel_device_us` over 5 calls). Run
parent, change, change, parent in one call to compare two versions on one
card. Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import warnings
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]
FIXTURES = HERE / "tests" / "fixtures" / "torch_port"


def syncs_per_image(dec, path: Path, iters: int = 5) -> float:
    """The synchronising operations of `iters` device halves of one image
    (its wire already on the card, one warm-up first), per image."""
    staged = dec.stage(path.read_bytes())
    wires = dec._to_device(staged)
    dec._run_device(staged, wires)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(iters):
                dec._run_device(staged, wires)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("called a synchronizing" in str(w.message)
               for w in caught) / iters


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not torch.cuda.is_available():
        print("usage: path_ab.py TREE (needs a CUDA device)", file=sys.stderr)
        return 1
    tree = Path(argv[0]).resolve()
    sys.path.insert(0, str(tree))
    for name in [m for m in sys.modules
                 if m.startswith(("jpeg_decoder_tpu", "tools"))]:
        del sys.modules[name]
    import jpeg_decoder_tpu_torch as jt
    from jpeg_decoder_tpu_torch.parallel import make_mesh
    from jpeg_decoder_tpu_torch.parallel.stripe_bits import (
        decode_bits_striped)
    from tools.torch_port_profile import kernel_device_us, profile

    def say(case: str, res: dict) -> None:
        print(json.dumps({"tree": str(tree), "case": case, **res}),
              flush=True)

    large, tower = FIXTURES / "large_420.jpg", FIXTURES / "tower_420.jpg"
    for precision in ("fast", "exact"):
        with jt.DeviceStreamDecoder(host_threads=1,
                                    precision=precision) as dec:
            res, _prof = profile(dec, large, 20)
            rate = dec.device_resident_rate(large.read_bytes(), iters=50)
            say(f"large_420 {precision}", {**res, "device_resident_ms":
                                           rate["ms_per_image"]})
            if precision == "fast":
                res, _prof = profile(dec, tower, 20, batch=16)
                rate = dec.device_resident_rate(tower.read_bytes(), iters=20,
                                                batch=16)
                say("tower_420 x16 fast", {**res, "device_resident_ms":
                                           rate["ms_per_image"]})
    with jt.DeviceStreamDecoder(host_threads=1,
                                interchange="prefix") as dec:
        res, _prof = profile(dec, large, 20)
        rate = dec.device_resident_rate(large.read_bytes(), iters=50)
        say("large_420 prefix fast", {
            **res, "device_resident_ms": rate["ms_per_image"],
            "syncs_per_image": syncs_per_image(dec, large)})
        res, _prof = profile(dec, tower, 20, batch=16)
        say("tower_420 x16 prefix fast", res)
    staged = jt.stage_host_bits(large.read_bytes())
    for n in (4, 8):
        mesh = make_mesh({"stripe": n}, ["cuda:0"] * n)
        prof = kernel_device_us(lambda: decode_bits_striped(staged, mesh),
                                "", iters=5)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            decode_bits_striped(staged, mesh)
        stop.record()
        stop.synchronize()
        say(f"large_420 at {n} stripes", {
            "launches_per_stripe": prof["all_launches"] / n,
            "device_busy_ms_per_stripe": prof["all_device_us"] / n / 1e3,
            "ms_per_stripe": start.elapsed_time(stop) / 5 / n})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

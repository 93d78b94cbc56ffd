#!/usr/bin/env python
"""End-to-end `decode_stream` ms/image of one checkout of the port, for A/B
runs on a card.

    python tools/experiments/stream_ab.py TREE [--reps N] [--puts]

TREE is the root of a checkout of this repository (this one: `.`; another
commit: unpack it with `git archive COMMIT | tar -x -C DIR` into a
directory `.gitignore` lists). The script imports the port from TREE and
times `DeviceStreamDecoder(host_threads=4).decode_stream` (bits, fast,
interleaved) from the bytes to the last image on the card (host clock,
synchronised), after one warm-up run, `reps` times for each case: tower_420
x 64 at batch 1 and 16, large_420 x 16 at batch 1 and 4 (this checkout's
fixtures). Prints one JSON line: the tree, the card's name and power
limit, and per case the ms/image of every run. Run parent, change, change,
parent in one call to compare two versions on one card.

With --puts (a checkout with `transfer.put`), every run is made once per
H2D route in turn, in one process, by swapping the stream's `put`: the
port's ("pinned": one pinned, non-blocking copy per submission), the
blocking copy from pageable memory of one array at a time that the stream
made before ("pageable"), and the port's followed by a stream
synchronisation ("pinned_sync"); the line then holds ms/image per route,
and per route and case the decoder's `StageTimer` stages in ms/image over
all its runs ("h2d_submit" holds the put) with, for "pinned", the pinned
pool's pageable-to-pinned copy time per image. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]
FIXTURES = HERE / "tests" / "fixtures" / "torch_port"
CASES = (("tower_420.jpg", 64, 1), ("tower_420.jpg", 64, 16),
         ("large_420.jpg", 16, 1), ("large_420.jpg", 16, 4))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", type=Path)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--puts", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stream_ab.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.tree.resolve()))
    from jpeg_decoder_tpu_torch import DeviceStreamDecoder

    routes = {None: None}
    if args.puts:
        import numpy as np

        import jpeg_decoder_tpu_torch.models.stream as stream_mod

        pinned = stream_mod.put

        def pageable(arrays, device):
            return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                         for a in arrays)

        def pinned_sync(arrays, device):
            out = pinned(arrays, device)
            torch.cuda.current_stream(device).synchronize()
            return out

        routes = {"pinned": pinned, "pageable": pageable,
                  "pinned_sync": pinned_sync}
    rows, stages = {}, {}
    with DeviceStreamDecoder(host_threads=4) as dec:
        for name, n, batch in CASES:
            case = f"{name} x{n} batch {batch}"
            stream = [(FIXTURES / name).read_bytes()] * n
            dec.decode_stream(stream, batch_size=batch)
            torch.cuda.synchronize()
            runs = {route: [] for route in routes}
            timers = {route: _timer() for route in routes}
            copy_s = {route: 0.0 for route in routes}
            for _ in range(args.reps):
                for route, fn in routes.items():
                    if fn is not None:
                        stream_mod.put = fn
                        dec.timer = timers[route]
                        before = _copy_seconds()
                    t0 = time.perf_counter()
                    dec.decode_stream(stream, batch_size=batch)
                    torch.cuda.synchronize()
                    runs[route].append((time.perf_counter() - t0) / n * 1e3)
                    if fn is not None:
                        copy_s[route] += _copy_seconds() - before
            dec.timer = None
            rows[case] = runs[None] if None in runs else runs
            if args.puts:
                stages[case] = {
                    route: {**{k: v * 1e3 / (n * args.reps)
                               for k, v in timers[route].totals.items()},
                            "pinned_copy": copy_s[route] * 1e3
                            / (n * args.reps)}
                    for route in routes}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"tree": str(args.tree), "card": card,
                      "ms_per_image": rows,
                      **({"stage_ms_per_image": stages} if stages else {})}))
    return 0


def _timer():
    from jpeg_decoder_tpu_torch.utils.timing import StageTimer

    return StageTimer()


def _copy_seconds() -> float:
    from jpeg_decoder_tpu_torch.transfer import pinned_pool

    return pinned_pool("cuda").copy_seconds


if __name__ == "__main__":
    sys.exit(main())

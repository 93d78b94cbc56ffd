#!/usr/bin/env python
"""The stream decoder's stages and sub-stages on a card: what tracing them
costs the host, and whether their ranges hold the card's work they enqueue.

    python tools/experiments/span_trace.py TREE [--calls N] [--rounds R]
                                           [--seed S] [--out DIR]

TREE is the root of a checkout of this repository (this one: `.`; another
commit: unpack it with `git archive COMMIT | tar -x -C DIR` into a directory
`.gitignore` lists); the port is imported from there, the inputs come from
this checkout's benchmark: the pool of `photo-large.exact-b8` (32 photos of
2268x1512, four size classes) from `--seed`, staged, then decoded in its
four calls of 8 through `_grouped(group, 8)`, each call's graphs warm
(three calls each first), two calls in flight.

1. Cost: `--calls` calls with a `StageTimer` with no profiler, under a
   profiler of the card alone (the benchmark's untraced run) and under one
   of the host and the card (its traced run), in turns over `--rounds`
   rounds. Per mode: each stage's host ms per call (its total over the
   calls) and a wrapper's of the module's `_merge` (as the benchmark's
   `merge_ms_per_call` times it), median and range over the rounds; each
   stage's count per call; calls per second.
2. Trace (a tree that has the sub-stages): four calls under the port's
   own `utils.timing.device_trace` (behind 20 ms of spin kernels), the
   Chrome trace read back: per stage and sub-stage its host ranges, the
   CUDA runtime calls each range holds on its thread, the card's
   operations those calls launched (by correlation id) and how many of
   them lie inside a device-side range of the same name; and one replay
   in full (its host range, its `cudaGraphLaunch`, its kernels with
   their start and end against the range's start on the card). One JSON
   line, the whole read into DIR/span_trace.json.

Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]
CELL = "photo-large.exact-b8"
STAGES = ("h2d_submit", "device_dispatch")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _card() -> str:
    return f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}"


def _window(call, n: int, in_flight: int = 2) -> float:
    """Seconds for calls 0..n-1, `in_flight` at a time (each issued once
    the call `in_flight` before it completed), all waited for. No wait
    before the first: a trace loses the card's work of the first ms after
    the host's last wait."""
    pending = []
    t0 = time.perf_counter()
    for k in range(n):
        if len(pending) >= in_flight:
            pending.pop(0)[0].synchronize()
        outs = call(k)
        event = torch.cuda.Event()
        event.record()
        pending.append((event, outs))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _profiler(mode: str):
    import contextlib

    from torch.profiler import ProfilerActivity, profile
    if mode == "off":
        return contextlib.nullcontext()
    acts = [ProfilerActivity.CUDA]
    if mode == "host+card":
        acts.append(ProfilerActivity.CPU)
    return profile(activities=acts)


def cost(jt, call, calls: int, rounds: int) -> list:
    """Per mode: each stage's host ms per call (its total over the calls)
    and a wrapper's of the module's `_merge` (as the benchmark's
    `merge_ms_per_call` times it), median [min, max] over the rounds; each
    stage's count per call; calls per second."""
    stream = sys.modules["jpeg_decoder_tpu_torch.models.stream"]
    real = stream._merge
    merge = [0.0]

    def wrapper(scans):
        t0 = time.perf_counter()
        out = real(scans)
        merge[0] += time.perf_counter() - t0
        return out

    modes = ["off", "card", "host+card"]
    got = {m: [] for m in modes}
    stream._merge = wrapper
    try:
        for r in range(rounds):
            for mode in modes[r % 3:] + modes[:r % 3]:
                timer = jt.StageTimer()
                call.dec.timer = timer
                merge[0] = 0.0
                torch.cuda.synchronize()
                with _profiler(mode):
                    seconds = _window(call, calls)
                call.dec.timer = None
                ms = {k: v * 1e3 / calls for k, v in timer.totals.items()}
                ms["merge_wrapper"] = merge[0] * 1e3 / calls
                got[mode].append((ms, {k: v / calls for k, v
                                       in timer.counts.items()},
                                  calls / seconds))
    finally:
        stream._merge = real
    rows = []
    for mode, runs in got.items():
        names = sorted({k for ms, _n, _rate in runs for k in ms})
        rows.append({"mode": mode, "calls": calls, "rounds": rounds,
                     "ms_per_call": {k: [
                         statistics.median(ms.get(k, 0.0)
                                           for ms, _n, _r in runs),
                         min(ms.get(k, 0.0) for ms, _n, _r in runs),
                         max(ms.get(k, 0.0) for ms, _n, _r in runs)]
                         for k in names},
                     "counts_per_call": runs[-1][1],
                     "calls_per_s": [r for _ms, _n, r in runs]})
    return rows


def read_trace(path: Path) -> dict:
    """The stages' ranges in a Chrome trace of `device_trace`, each with
    the runtime calls it holds and the card's operations they launched."""
    ev = json.loads(path.read_text())["traceEvents"]
    ev = [e for e in ev if e.get("ph") == "X"]
    host = [e for e in ev if e.get("cat") == "user_annotation"
            and e["name"].startswith(STAGES)]
    runtime = [e for e in ev if e.get("cat") in ("cuda_runtime",
                                                 "cuda_driver")]
    ops = {}
    for e in ev:
        if e.get("cat") in DEVICE_CATS:
            ops.setdefault(e.get("args", {}).get("correlation"), []).append(e)
    mirror = {}
    for e in ev:
        if e.get("cat") == "gpu_user_annotation":
            mirror.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))

    def inside(op, name):
        return any(s <= op["ts"] and op["ts"] + op["dur"] <= t
                   for s, t in mirror.get(name, []))

    by_name, replays = {}, []
    for r in host:
        end = r["ts"] + r["dur"]
        calls = [c for c in runtime if c["tid"] == r["tid"]
                 and r["ts"] <= c["ts"] and c["ts"] + c["dur"] <= end]
        launched = [op for c in calls
                    for op in ops.get(c.get("args", {}).get("correlation"),
                                      [])]
        row = by_name.setdefault(r["name"], {
            "ranges": 0, "host_us": 0.0, "runtime_calls": {},
            "card_ops": 0, "card_ops_inside_its_range": 0})
        row["ranges"] += 1
        row["host_us"] += r["dur"]
        for c in calls:
            row["runtime_calls"][c["name"]] = \
                row["runtime_calls"].get(c["name"], 0) + 1
        row["card_ops"] += len(launched)
        row["card_ops_inside_its_range"] += sum(inside(op, r["name"])
                                                for op in launched)
        if r["name"] == "device_dispatch.replay" and launched:
            spans = [(s, t) for s, t in mirror.get(r["name"], [])
                     if any(s <= op["ts"] < t for op in launched)]
            s0 = spans[0][0] if spans else min(op["ts"] for op in launched)
            replays.append({
                "host_range_us": [r["ts"], r["dur"]],
                "runtime": [[c["name"], round(c["ts"] - r["ts"], 1),
                             c["dur"]] for c in calls],
                "card_range_us": [list(x) for x in spans[:1]],
                "card_ops": [[op["name"][:60], round(op["ts"] - s0, 1),
                              round(op["ts"] + op["dur"] - s0, 1)]
                             for op in sorted(launched,
                                              key=lambda o: o["ts"])]})
    return {"stages": by_name, "replays": len(replays),
            "one_replay": replays[len(replays) // 2] if replays else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree")
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=3_100_000_501)
    ap.add_argument("--out", default="chiprun_out/span_trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_trace.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from portbench.harness import registry
    from portbench.harness.trace import spin_fill
    cell = registry.workload(CELL)
    cfg = registry.config(cell["config"])
    pool = registry.generator(cfg["generator"]).generate(cfg, cell,
                                                         args.seed)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    for name in [m for m in sys.modules
                 if m.startswith("jpeg_decoder_tpu")]:
        del sys.modules[name]
    import jpeg_decoder_tpu_torch as jt
    from jpeg_decoder_tpu_torch.utils.timing import device_trace

    dec = jt.DeviceStreamDecoder(**cfg["decoder"])
    staged = [dec.stage(it["jpeg"]) for it in pool]
    batch = cell["batch"]
    groups = [staged[i:i + batch] for i in range(0, len(staged), batch)]

    def call(k):
        return dec._grouped(groups[k % len(groups)], batch)
    call.dec = dec
    for k in range(3 * len(groups)):
        call(k // 3)
    torch.cuda.synchronize()
    line = {"tree": str(tree), "card": _card(), "seed": args.seed,
            "cost": cost(jt, call, args.calls, args.rounds)}
    if hasattr(jt.utils.timing, "span"):
        out = Path(args.out) / tree.name
        dec.timer = jt.StageTimer()
        with device_trace(str(out)):
            spin_fill()
            _window(call, 4)
        line["trace"] = read_trace(out / "trace.json")
        line["trace_counts"] = dict(dec.timer.counts)
        dec.timer = None
        (out / "span_trace.json").write_text(json.dumps(line, indent=1))
    dec.close()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

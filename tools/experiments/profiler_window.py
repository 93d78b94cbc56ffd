#!/usr/bin/env python
"""How often a torch.profiler trace loses the card's kernels, and where,
on one route of `chip_smoke.py`'s phase 28, on a card.

    python3 tools/experiments/profiler_window.py [--traces N]
        [--route LABEL ...] [--margins S,S] [--cpu] [--eager]

A route is a GRAPH_ROUTES label (default "large_420 fast planar": one
image landed every call and replayed from its key's graph, U1, K1, A1,
K2, T1 a replay). Each trace is a warm-up step of 3 calls, then an
active step of GRAPH_PROFILED calls, each step synchronised, its calls
`margin` seconds of idle host time from either edge (no spin kernels:
`chip_smoke.replay_kernels` as it was before its fill). N traces
(default 30) at each margin (default 0 and MARGIN_S, 50 ms), margins
alternating, of the replay and, with --eager, of the eager body on the
same landed inputs.
With --cpu the trace also records the host (CPU activity): each launch's
runtime call, so that a lost kernel's launch is seen.

Prints one JSON line per route: per call kind and margin, the traces
whose kernels by name all come as often as in GRAPH_PROFILED eager
bodies (the most that any of five traces of them counts; beside it one
eager body's `_build.LAUNCHES`), the kernels lost in all, the range of
the first device event's start and the last one's end (µs from the
trace's start) beside the active step's host time; and for the first five traces that lost
kernels, every device event in order (name, start µs, duration µs) with,
under --cpu, the runtime calls whose kernel the trace lacks.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import jpeg_decoder_tpu_torch as jt  # noqa: E402

MARGIN_S = 0.05
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")


def trace(run, margin: float, cpu: bool) -> dict:
    """One trace of GRAPH_PROFILED calls of `run`."""
    from torch.profiler import ProfilerActivity, profile, schedule

    got: dict = {}

    def traced(prof) -> None:
        ev = prof.events()
        dev = [e for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA]
        got["device"] = [(e.name, e.id, e.time_range.start,
                          e.time_range.end - e.time_range.start)
                         for e in dev]
        got["launches"] = [(e.name, e.id, e.time_range.start) for e in ev
                           if e.device_type == torch.autograd.DeviceType.CPU
                           and e.name in LAUNCH_CALLS]

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=traced) as prof:
        for n in (3, cs.GRAPH_PROFILED):
            t0 = time.perf_counter()
            time.sleep(margin)
            for _ in range(n):
                run()
            torch.cuda.synchronize()
            time.sleep(margin)
            got["step_us"] = (time.perf_counter() - t0) * 1e6
            prof.step()
    return got


def short(name: str) -> str:
    return cs.kernel_name(name) if "Memcpy" not in name \
        and "Memset" not in name else name.split(" (")[0]


def kernels(got: dict) -> dict:
    out: dict = {}
    for name, *_ in got.get("device", []):
        if "Memcpy" not in name and "Memset" not in name:
            out[name] = out.get(name, 0) + 1
    return out


def route(label: str, args) -> dict:
    _, opts, source, batch = next(r for r in cs.GRAPH_ROUTES
                                  if r[0] == label)
    blob = cs.route_blob({source: (cs.FIXTURES / source).read_bytes()}
                         if isinstance(source, str) else {}, source)
    with jt.DeviceStreamDecoder(host_threads=1, **opts) as dec:
        calls = cs.graph_calls(dec, blob, batch)
        runs = {"replay": calls["replay_landed"]}
        if args.eager:
            runs["eager"] = calls["eager_landed"]
        for _ in range(3):              # the warm-up and capture, replays
            runs["replay"]()
        torch.cuda.synchronize()
        jt.reset_launches()
        calls["eager_landed"]()
        torch.cuda.synchronize()
        launches = {k: v for k, v in jt.LAUNCHES.items() if v}
        # The kernels by name of GRAPH_PROFILED eager bodies: the most any
        # of five traces counts, the count every trace must reach.
        want: dict = {}
        for _ in range(5):
            k = kernels(trace(calls["eager_landed"], MARGIN_S,
                              False))
            if sum(k.values()) > sum(want.values()):
                want = k
        seen: dict = {(kind, m): [] for kind in runs for m in args.margins}
        for _ in range(args.traces):
            for kind, run in runs.items():
                for m in args.margins:
                    seen[(kind, m)].append(trace(run, m, args.cpu))
    out = {}
    for (kind, m), got in seen.items():
        exact, lost, detail = 0, {}, []
        for g in got:
            k = kernels(g)
            ok = all(k.get(n, 0) == v for n, v in want.items()) \
                and set(k) <= set(want)
            exact += ok
            for n, v in want.items():
                if k.get(n, 0) < v:
                    lost[short(n)] = lost.get(short(n), 0) + v - k.get(n, 0)
            if not ok and len(detail) < 5:
                ids = {i for _, i, _, _ in g.get("device", [])}
                detail.append({
                    "device": [[short(n), round(s, 1), round(d, 1)]
                               for n, _, s, d in g.get("device", [])],
                    "launches_without_kernel": [
                        [n, round(s, 1)] for n, i, s in g.get("launches", [])
                        if i not in ids]})
        firsts = [g["device"][0][2] for g in got if g.get("device")]
        lasts = [max(s + d for _, _, s, d in g["device"])
                 for g in got if g.get("device")]
        out[f"{kind} {m}"] = {
            "traces": len(got), "exact": exact, "kernels_lost": lost,
            "first_event_us": [min(firsts), max(firsts)] if firsts else None,
            "last_event_end_us": [min(lasts), max(lasts)] if lasts else None,
            "active_step_host_us": [min(g["step_us"] for g in got),
                                    max(g["step_us"] for g in got)],
            "lost_traces": detail}
    return {"route": label, "cpu_activity": args.cpu,
            "launches_per_eager_body": launches,
            "want_per_trace": {short(n): v for n, v in want.items()},
            "by_call_and_margin": out}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--traces", type=int, default=30)
    ap.add_argument("--route", nargs="*", default=["large_420 fast planar"])
    ap.add_argument("--margins", default=f"0,{MARGIN_S}",
                    type=lambda s: [float(x) for x in s.split(",")])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--eager", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    for label in args.route:
        print(json.dumps(route(label, args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

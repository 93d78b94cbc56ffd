"""One run of one cell: inputs from the seed, set-up, the window, the check,
the result line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1> [--control]

The entry the window drives is the device half of
`DeviceStreamDecoder.decode_stream` on images that `DeviceStreamDecoder.
stage` staged in set-up: at batch 1 `decode_one(staged)`, what
`decode_stream(batch_size=1)` calls per image; at batch N the grouping loop
`_grouped(staged, N)`, what `decode_stream(batch_size=N)` runs after
staging. Call k decodes the pool's call input k % inputs (the pool cut
into groups of the cell's batch, in order).

Standard output: three JSON lines (the inputs: pool, bytes a pixel,
generation time; the window: calls, set-up, the program's stage ms a
call, images completed each second, the host's CPU ms an image and its
involuntary context switches a second, the card's busy seconds and the
harness's own, the card and its power limit; after the window: the
seconds the trace's reading and the check took), then the result as the
last line. On a card every run profiles the device over its window
(`--trace 1` the host as well): the card's busy time is an end-to-end
metric. Standard error ends with each compared number beside its
limit. `--control` runs the configuration's control in the program's
place (the benchmark's own runs never do): it must come out not
correct. A traced run exits with an error where a per-layer metric that
`BENCHMARK.json` lists for the cell reads nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import resource
import statistics
import subprocess
import sys
import time

import torch

from ..gen.textured import rng_for
from . import check, loop, registry, roofline
from . import trace as trace_mod
from .readings import Readings

PORT = "jpeg_decoder_tpu_torch"
# Top-level module names that may not be loaded when the window closes:
# JAX, its libraries and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "jpeg_decoder_tpu")
# Calls per distinct input in the warm-up: the key's eager first call,
# its capture, a replay.
WARM_CALLS = 3
# Cycles through the inputs among which each input's early checked call is
# drawn (its late one: `check.LATE`).
SAMPLE_CYCLES = 4
END_TO_END_UNITS = {"card_ms_per_image": "ms", "setup_s": "s"}


def emit(tag: str, **fields) -> None:
    print(json.dumps({"portbench": tag, **fields}), flush=True)


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


def run(cell: dict, seed: int, seconds: float, traced: bool,
        device: torch.device, control: bool = False,
        config: dict = None) -> dict:
    """One run of `cell` (`registry.workload`); `config` replaces the
    cell's configuration (tests: the same deployment at a small size).
    Returns the result line's object."""
    cfg = config or registry.config(cell["config"])
    ref = registry.reference(cfg["reference"])
    t = time.perf_counter()
    pool = registry.generator(cfg["generator"]).generate(cfg, cell, seed)
    px = cfg["width"] * cfg["height"]
    emit("inputs", cell=cell["name"], seed=seed, pool=len(pool),
         generation_s=time.perf_counter() - t,
         jpeg_bytes_mean=statistics.fmean(len(it["jpeg"]) for it in pool),
         bytes_per_pixel=statistics.fmean(len(it["jpeg"]) for it in pool)
         / px)

    # Set-up: from the port's first import to the first timed call.
    t_setup = time.perf_counter()
    port = importlib.import_module(PORT)
    stream = importlib.import_module(PORT + ".models.stream")
    transfer = importlib.import_module(PORT + ".transfer")

    class SpanTimer(port.StageTimer):
        """The program's `StageTimer`, each stage also a profiler range."""

        @contextlib.contextmanager
        def stage(self, name: str):
            with trace_mod.span(name), super().stage(name):
                yield

    timer = SpanTimer() if traced else port.StageTimer()
    args = dict(cfg["decoder"])
    if control:
        args.update(cfg["control"].get("program", {}))
    dec = port.DeviceStreamDecoder(device=device, timer=timer, **args)
    staged = [dec.stage(it["jpeg"]) for it in pool]
    staging = (timer.totals["host_stage"], timer.counts["host_stage"])
    batch = cell["batch"]
    calls = [list(range(i, min(i + batch, len(pool))))
             for i in range(0, len(pool), batch)]
    groups = [[staged[i] for i in c] for c in calls]

    def call(k: int) -> list:
        group = groups[k % len(groups)]
        if batch > 1:
            return dec._grouped(group, batch)
        return [dec.decode_one(group[0])]

    shapes = {}
    for k in range(WARM_CALLS * len(calls)):
        outs = call(k // WARM_CALLS)
        shapes[k // WARM_CALLS] = [(o.shape, o.dtype) for o in outs]
    del outs
    loop.run(call, float("inf"), cell["in_flight"], {}, device,
             max_calls=2 * len(calls))
    # The sampled calls' host buffers: the harness's, not set-up's.
    t_alloc = time.perf_counter()
    early, late_at = check.sample(rng_for(seed, 3), len(calls),
                                  SAMPLE_CYCLES)

    def host_buffers(g):
        return [torch.empty(sh, dtype=dt, pin_memory=True)
                for sh, dt in shapes[g]] if device.type == "cuda" else None

    buffers = {k: host_buffers(g) for k, g in early.items()}
    late = {g: (share * seconds, host_buffers(g))
            for g, share in late_at.items()}
    alloc_s = time.perf_counter() - t_alloc
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    timer.reset()
    pinned = transfer.pinned_pool(device) if device.type == "cuda" else None
    copied0 = pinned.copied_bytes if pinned else None
    captures0 = dec._graphs.stats()["captures"]

    merge = [0.0, 0]
    orig_merge = stream._merge
    if traced:
        def timed_merge(scans):
            t0 = time.perf_counter()
            with trace_mod.span("portbench.merge"):
                out = orig_merge(scans)
            merge[0] += time.perf_counter() - t0
            merge[1] += 1
            return out
        stream._merge = timed_merge
    keep = torch.cuda.Stream(device) if device.type == "cuda" else None
    setup_s = time.perf_counter() - t_setup - alloc_s
    host = [time.process_time(), _switches()]
    try:
        if keep is not None:
            with trace_mod.profile(host=traced) as prof:
                trace_mod.spin_fill()
                trace_mod.mark(keep)
                host = [time.process_time(), _switches()]
                win = loop.run(call, seconds, cell["in_flight"], buffers,
                               device, span=trace_mod.span if traced
                               else None, late=late, inputs=len(calls),
                               stream=keep)
                torch.cuda.synchronize(device)
                host = [time.process_time() - host[0],
                        _switches() - host[1]]
            t_read = time.perf_counter()
            tr = trace_mod.read(prof)
            del prof
            read_s = time.perf_counter() - t_read
        else:
            win = loop.run(call, seconds, cell["in_flight"], buffers, device,
                           late=late, inputs=len(calls))
            host = [time.process_time() - host[0], _switches() - host[1]]
            tr, read_s = None, 0.0
    finally:
        stream._merge = orig_merge
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    lat = [d - s for s, d in zip(win.starts, win.dones) if d is not None]
    readings = Readings(
        calls=win.calls, images=sum(win.images), window_s=seconds,
        images_done=win.images_done(), latencies=lat,
        calls_items=[[pool[i] for i in c] for c in calls],
        stages={name: (timer.totals[name], timer.counts[name])
                for name in timer.totals},
        staging=staging, merge=tuple(merge) if merge[1] else None,
        h2d_bytes=pinned.copied_bytes - copied0 if pinned else None,
        captures=dec._graphs.stats()["captures"] - captures0, trace=tr,
        hbm=roofline.hbm_bytes_per_s(kind))
    emit("window", calls=win.calls, images=sum(win.images),
         images_done=win.images_done(), setup_s=setup_s,
         stage_ms_per_call=timer.per_call_ms(),
         images_each_second=win.per_second(),
         host_cpu_ms_per_image=host[0] * 1e3 / max(sum(win.images), 1),
         involuntary_switches_per_s=host[1] / seconds,
         card_busy_s=tr.busy_s if tr else None,
         harness_card_s=tr.harness_s if tr else None,
         device=kind,
         power_limit=_power_limit() if device.type == "cuda" else None)

    # The program's state freed, the reference checks the sampled calls.
    dec.close()
    del dec, staged, groups, call, buffers, late
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if win.error is not None:
        raise win.error
    t_check = time.perf_counter()
    sampled = list(early.items()) + [(win.late.get(g), g) for g in late_at]
    vals = check.compare(win.kept, sampled, calls, pool,
                         lambda item, dev: ref.expected(item, cfg, dev),
                         device)
    emit("after", trace_read_s=read_s,
         check_s=time.perf_counter() - t_check)

    metrics = {}
    if traced:
        for name, reader in registry.metric_readers().items():
            value = reader.read(readings)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
        silent = sorted(registry.listed_per_layer(cell["name"]) - set(metrics))
        if silent:
            raise MissingReading(
                f"{cell['name']}: per-layer metrics listed for the cell read "
                f"nothing: {silent}")
    else:
        values = {"setup_s": setup_s}
        if tr is not None:
            values["card_ms_per_image"] = tr.busy_s * 1e3 / sum(win.images)
        metrics = {name: {"value": v, "unit": END_TO_END_UNITS[name]}
                   for name, v in sorted(values.items())}
    result = {"correct": check.passed(vals), "attempted": sum(win.images),
              "failed": vals["wrong_images"] + vals["missing_images"],
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else "cpu", "kind": kind, "count": 1,
                         "memory_peak_bytes": peak}}
    if traced:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {name: {"value": v, "limit": check.LIMITS[name]}
                        for name, v in vals.items()}
    return result


class MissingReading(RuntimeError):
    """A per-layer metric that `BENCHMARK.json` lists for the cell found
    nothing to read: its span, counter or kernel has moved."""


def _switches() -> int:
    """The process's involuntary context switches so far: how often the
    host took its core away."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the configuration's control in the "
                    "program's place")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if importlib.util.find_spec(PORT) is None:
        print(f"{PORT} is not in this checkout", file=sys.stderr)
        return 2
    cell = registry.workload(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    try:
        result = run(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), control=args.control)
    except MissingReading as e:
        print(e, file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the run may not load: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    return 0

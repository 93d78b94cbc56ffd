"""Where the device time of the PyTorch port's main path goes, on a CUDA card.

    python tools/torch_port_profile.py [--iters N] [--stream N] [--batch N]
                                       [--layout L] [--precision P]
                                       [--interchange I] [--trace out.json]
                                       [fixture ...]

For each fixture (default: the 3.4 Mpix and 512x512 4:2:0 fixtures in
tests/fixtures/torch_port/) it first times `decode_stream` end to end over
`stream` copies at `batch_size=batch` (host staging on 4 pool threads, H2D,
device), then runs it again under torch.profiler for the card's idle share
over that run; then it stages the wire and copies it to the card once (for
batch > 1, `batch` copies merged into one group, as `decode_stream` merges
a group) and runs `iters` device-resident decodes, unprofiled (CUDA events,
`device_resident_rate`) and under torch.profiler, in the decoder layout
`--layout` (default interleaved; "planar-pallas" runs kernel K3),
precision `--precision` (default fast; "exact" runs the int32 IDCT) and
interchange `--interchange` (default bits). Printed per fixture, as JSON
lines (per image: a group's numbers divided by its images):
- end to end: ms/image, Mpix/s and the card's idle share (1 - the union
  of kernel intervals over the wall time of the profiled run);
- wall ms/image over the profiled device-resident window (host clock,
  synchronised);
- device busy ms/image (union of kernel intervals) and the idle share;
- kernel ms/image per layer (a kernel belongs to the innermost of the
  decoder's record_function ranges it starts in: unpack_delta, k1_decode,
  assemble, prefix_stores, reconstruct, fused_tail and interleaved_tail
  inside reconstruct, and lossless; a kernel of a replayed CUDA graph,
  whose ranges ran at capture and not at replay, to its layer by its
  name, `KERNEL_LAYERS`) and per kernel name (K1
  huffman_decode_kernel, K2 dequant_idct_kernel, K3 fused_tail_kernel, L1
  lossless_recur_kernel, E1 idct_exact_kernel, T1
  interleaved_tail_kernel, A1 assemble_kernel, U1 unpack_delta_kernel,
  P1 prefix_base_kernel and prefix_resid_kernel, D1 dc_totals_kernel,
  the rest PyTorch's);
- kernel launches per image.
With --trace, the Chrome trace of the last fixture is written there.
Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"
LAYERS = ("unpack_delta", "k1_decode", "assemble", "prefix_stores",
          "reconstruct", "fused_tail", "interleaved_tail", "lossless")
# The span around a graph's replay (models/graphs.py): it holds no layer.
GRAPH_SPAN = "bits_graph"
# A kernel's layer by its name, for kernels outside every layer's range.
KERNEL_LAYERS = (("unpack_delta_kernel", "unpack_delta"),
                 ("huffman_decode_kernel", "k1_decode"),
                 ("assemble_kernel", "assemble"),
                 ("prefix_", "prefix_stores"),
                 ("dequant_idct_kernel", "reconstruct"),
                 ("idct_exact_kernel", "reconstruct"),
                 ("fused_tail_kernel", "fused_tail"),
                 ("interleaved_tail_kernel", "interleaved_tail"),
                 ("lossless_recur_kernel", "lossless"))


def layer_of_name(name: str) -> str:
    return next((layer for sym, layer in KERNEL_LAYERS if sym in name),
                "other")


def _busy_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


# A trace loses the card's work of the first ms or so after the host's
# last wait, so the `iters` calls of `kernel_device_us` follow SPIN_FILL_S
# of spin kernels launched back to back, and only what follows the last
# spin kernel the trace holds is counted.
SPIN_FILL_S = 0.02


def _after_spin_fill(fn, iters: int, fill: float) -> list:
    """The card's operations of `iters` calls of `fn` in one trace, behind
    `fill` seconds of spin kernels: those after the last spin kernel the
    trace holds (none if it holds none)."""
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        end = time.perf_counter() + fill
        while time.perf_counter() < end:
            torch.cuda._sleep(1000)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    held = [e.time_range.start for e in ev if "spin_kernel" in e.name]
    if not held:
        return []
    return [e for e in ev if "spin_kernel" not in e.name
            and e.time_range.start > held[-1]]


def kernel_device_us(fn, symbol: str, iters: int = 20) -> dict:
    """Device time of the kernels whose name contains `symbol`, per call of
    `fn`, from torch.profiler over `iters` calls after three warm-up calls
    (warm L2), behind a fill of spin kernels (`_after_spin_fill`; a trace
    that holds fewer than one such kernel a call is taken again with twice
    the fill): {"kernel_us", "launches", "each_us", "all_device_us",
    "all_launches"}: "each_us" every such kernel's own time in the window,
    the last two over every device operation `fn` enqueues."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    on_card = mine = []
    for attempt in range(4):
        on_card = _after_spin_fill(fn, iters, SPIN_FILL_S * 2 ** attempt)
        mine = [e for e in on_card if symbol in e.name]
        if len(mine) >= iters:
            break
    if not mine:
        raise RuntimeError(f"the profiler saw no {symbol!r} kernel; names: "
                           f"{sorted({e.name for e in on_card})[:8]}")
    # The trace may drop an event at the edge of the window: average over
    # the events seen, times the launches one call makes.
    per_call = max(1, round(len(mine) / iters))
    return {"kernel_us": sum(e.time_range.elapsed_us() for e in mine)
            / len(mine) * per_call,
            "launches": per_call,
            "each_us": [e.time_range.elapsed_us() for e in mine],
            "all_device_us": sum(e.time_range.elapsed_us()
                                 for e in on_card) / len(on_card)
            * round(len(on_card) / iters),
            "all_launches": round(len(on_card) / iters)}


def card_span_us(fn, iters: int = 100) -> dict:
    """The card's time from the start of a call's first kernel to the end
    of its last, the gaps between its launches included: CUDA events
    around each of `iters` calls, each enqueued behind a
    `torch.cuda._sleep` long enough that the card never waits for the
    host. {"span_median_us", "span_min_us", "span_max_us"}; the events' own
    cost (~4-5 µs on an H100) is in every span."""
    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in marks:
        torch.cuda._sleep(200_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    each = sorted(start.elapsed_time(end) * 1e3 for start, end in marks)
    return {"span_median_us": each[len(each) // 2], "span_min_us": each[0],
            "span_max_us": each[-1]}


def _kernels(prof) -> list:
    """The card's kernels of a profile; record_function ranges also appear
    on the device timeline, as spans around kernels, not kernels."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in LAYERS and e.name != GRAPH_SPAN]


def profile(dec, path: Path, iters: int, batch: int = 1):
    """Profile `iters` device-resident decodes of the JPEG at `path`,
    staged by the decoder's interchange and precision: of one image, or of
    a group of `batch` copies (per-image numbers divide by `batch`)."""
    from torch.profiler import ProfilerActivity

    from jpeg_decoder_tpu_torch.models.stream import _kind

    staged = dec.stage(path.read_bytes())
    group = [staged] * batch

    def land():
        """A call on the wire landed once."""
        if batch > 1:
            wires = dec._group_wires(_kind(staged), group)
            if wires is None:
                raise ValueError(f"{path.name} does not group")
            return lambda: dec._run_group(_kind(staged), group, wires)
        one = dec._to_device(staged)
        return lambda: dec._run_device(staged, one)
    land()()            # a bits key's first call runs off any graph
    run = land()        # then on its graph, replayed
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e for e in on_card if e.name in LAYERS]
    kernels = _kernels(prof)
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    images = iters * batch
    by_kernel = defaultdict(float)
    layers = defaultdict(float)
    for e in kernels:
        ms = e.time_range.elapsed_us() / images / 1e3
        by_kernel[e.name] += ms
        owners = [s for s in spans if s.time_range.start
                  <= e.time_range.start < s.time_range.end]
        owner = max(owners, key=lambda s: s.time_range.start).name \
            if owners else layer_of_name(e.name)
        layers[owner] += ms
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    return {"fixture": path.name, "layout": dec.layout,
            "precision": dec.precision, "interchange": dec.interchange,
            "batch": batch, "mpix": staged.mpix,
            "wall_ms": wall / images * 1e3,
            "device_busy_ms": busy / images / 1e3,
            "idle_share": 1 - busy / (wall * 1e6),
            "launches_per_image": len(kernels) / images,
            "layer_kernel_ms": dict(layers), "top_kernels_ms": top,
            "device": torch.cuda.get_device_name(0)}, prof


def stream_rate(dec, path: Path, n: int, batch: int = 1) -> dict:
    """End to end: decode_stream over n copies at batch_size `batch` (host
    staging in the pool, H2D, device), wall clock until the last image is
    on the card, after a warm-up of two full groups (a key's first call
    runs eagerly and its second captures its graph, `models/graphs.py`:
    the timed run is the steady state); then the same run under
    torch.profiler for the card's idle share (the profiler's own cost
    lengthens that run's wall time, so the share is an upper bound)."""
    from torch.profiler import ProfilerActivity

    data = [path.read_bytes()] * n
    dec.decode_stream(data[:2 * batch], batch_size=batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = dec.decode_stream(data, batch_size=batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        dec.decode_stream(data, batch_size=batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    busy = _busy_us((e.time_range.start, e.time_range.end)
                    for e in _kernels(prof))
    h, w = out[0].shape[-2:] if dec.layout.startswith("planar") \
        else out[0].shape[:2]          # [C, H, W] or [H, W, C]; gray [H, W]
    mpix = h * w / 1e6
    return {"fixture": path.name, "images": n, "batch": batch,
            "ms_per_image": wall / n * 1e3, "mpix_s": mpix * n / wall,
            "host_threads": dec.host_threads,
            "profiled_ms_per_image": prof_wall / n * 1e3,
            "device_busy_ms_per_image": busy / n / 1e3,
            "idle_share": 1 - busy / (prof_wall * 1e6)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fixtures", nargs="*",
                    default=["large_420.jpg", "tower_420.jpg"])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--stream", type=int, default=32,
                    help="images per end-to-end decode_stream run")
    ap.add_argument("--batch", type=int, default=1,
                    help="decode_stream's batch_size, and the images of "
                    "one device-resident group")
    ap.add_argument("--layout", default="interleaved",
                    choices=("interleaved", "planar", "planar-pallas"))
    ap.add_argument("--precision", default="fast", choices=("fast", "exact"))
    ap.add_argument("--interchange", default="bits",
                    choices=("bits", "prefix"))
    ap.add_argument("--trace", type=Path,
                    help="write the last fixture's Chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from jpeg_decoder_tpu_torch import DeviceStreamDecoder

    with DeviceStreamDecoder(device="cuda", host_threads=4,
                             layout=args.layout, precision=args.precision,
                             interchange=args.interchange) as dec:
        for name in args.fixtures:
            print(json.dumps({"stream": stream_rate(
                dec, FIXTURES / name, args.stream, args.batch)}))
            print(json.dumps({"device_resident": dec.device_resident_rate(
                (FIXTURES / name).read_bytes(), iters=args.iters,
                batch=args.batch)}))
            res, prof = profile(dec, FIXTURES / name, args.iters, args.batch)
            print(json.dumps(res))
        if args.trace is not None:
            args.trace.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())

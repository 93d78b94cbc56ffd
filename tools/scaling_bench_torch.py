#!/usr/bin/env python
"""Mesh sweep of the PyTorch port: what the data and stripe axes cost, over
slots of one device. The counterpart of tools/scaling_bench.py.

One device's slots share it (`["cuda:0"] * n` on the card, `["cpu"] * n`
here), so no speed-up is possible and none is reported: every row is the
OVERHEAD of the partition, t1/tN, where 1.0 means the N-slot program costs
what the 1-slot program costs. Three parts, as the reference's:

1. DP throughput (tools/scaling_bench.py:42-71): B = batch-per-device x N
   copies of the image's stores through `parallel.decode_batch_sharded`
   over {"data": N} (precision "fast": kernel K2); ms per call, Mpix/s,
   and t1/tN per image.
2. Fixed-batch overhead (:73-97): the same B = batch-per-device x max(N)
   at every N; t1/tN per call.
3. Stripe-bits overhead (:99-130): the ONE image, entropy decode included,
   through `parallel.stripe_bits.decode_bits_striped` over {"stripe": N}
   (N >= 2), against the one-device bits pipeline at precision "exact"
   (the stripes' IDCT; the reference compares with its default
   precision); t1/tN per image.

Each row also has the launches per image: every kernel on the card by
torch.profiler (one profiled call; "not measured" on the CPU, which runs
no kernel) and the hand-written kernels' `LAUNCHES`, and whether its output
is bit-equal to the 1-slot output (DP) or to the one-device exact decode
(stripes); any difference fails the run. Times: CUDA events on the card,
`time.perf_counter` on the CPU, best of 3 calls after one warm call.

With --processes 2 the stripe sweep runs across two processes joined by
torch.distributed (gloo over 127.0.0.1, tools/multiproc_mesh_torch.py's
launcher), N/2 slots each, and each rank reports its own times against its
own one-device decode.

Usage:
  python tools/scaling_bench_torch.py [--image PATH] [--batch-per-device 2]
      [--device cuda|cpu] [--slots 1,2,4,8] [--processes 1|2]
The default image is tests/fixtures/torch_port/large_420.jpg; the default
device is the card ("cuda"); without one it fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
DEFAULT_IMAGE = REPO / "tests" / "fixtures" / "torch_port" / "large_420.jpg"
HEADER = ("one device's slots share it: every row is the partition's "
          "overhead t1/tN (1.0 = no cost), not scaling; no speed-up is "
          "possible or claimed")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def best_ms(fn, dev: torch.device, reps: int = 3) -> float:
    """Best of `reps` calls of fn after one warm call: CUDA events on a
    card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def launches(fn, dev: torch.device) -> tuple:
    """(kernels on the card per call of fn by torch.profiler, or None on
    the CPU; the hand-written kernels' LAUNCHES per call)."""
    import jpeg_decoder_tpu_torch as jt

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    jt.reset_launches()
    if dev.type != "cuda":
        fn()
        return None, dict(jt.LAUNCHES)
    from torch.profiler import ProfilerActivity

    from tools.torch_port_profile import _kernels
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    return len(_kernels(prof)), dict(jt.LAUNCHES)


def _row(part: str, slots: int, batch: int, call, dev: torch.device,
         mpix: float, equal: bool, t1=None) -> dict:
    """One timed row: `call` decodes `batch` images of `mpix` each on
    `slots` slots; `t1` is the part's 1-slot ms per image (None: this row
    is that one)."""
    ms = best_ms(call, dev)
    every, kernels = launches(call, dev)
    per_image = ms / batch
    return {"part": part, "slots": slots, "batch": batch, "ms": ms,
            "mpix_per_s": batch * mpix / ms * 1e3,
            "launches_per_image": None if every is None else every / batch,
            "kernel_launches_per_image": {k: v / batch
                                          for k, v in kernels.items() if v},
            "overhead_t1_over_tn": 1.0 if t1 is None else t1 / per_image,
            "equal": bool(equal)}


def host_stores(data: bytes) -> tuple:
    """(geometry at "fast", per-component int16 [n, 64] stores, tables,
    Mpix) of the host copy's entropy decode."""
    from jpeg_decoder_tpu_torch.host.decoder import Decoder
    from jpeg_decoder_tpu_torch.host.ops.pipeline import geometry_from_frame

    d = Decoder(data, backend="numpy")
    d._decode_entropy_only()
    n = len(d.frame.components)
    stores = [d._pending_render[i][0].reshape(-1, 64) for i in range(n)]
    qts = [d._pending_render[i][1] for i in range(n)]
    transform = None if n == 1 else d._determine_color_transform()
    info = d.info()
    return (geometry_from_frame(d.frame, transform, precision="fast"),
            stores, qts, info.width * info.height / 1e6)


def sweep_dp(data: bytes, slots, dev: torch.device, batch_per_device: int,
             log=print) -> list:
    """Parts 1 and 2: rows of DP throughput (batch_per_device x N images on
    N slots) and fixed-batch overhead (batch_per_device x max(N) on every
    N)."""
    from jpeg_decoder_tpu_torch.parallel import (decode_batch_sharded,
                                                 make_mesh)

    geometry, stores, qts, mpix = host_stores(data)
    rows = []
    for part in ("dp", "fixed_batch"):
        ref = t1 = None
        for n in slots:
            b = batch_per_device * (n if part == "dp" else max(slots))
            inputs = [np.broadcast_to(s, (b,) + s.shape).copy()
                      for s in stores]
            mesh = make_mesh({"data": n}, [dev] * n)

            def call():
                return decode_batch_sharded(geometry, inputs, qts, mesh)

            out = call()
            ref = out[0] if ref is None else ref
            rows.append(_row(part, n, b, call, dev, mpix,
                             all(np.array_equal(o, ref) for o in out), t1))
            t1 = t1 or rows[-1]["ms"] / b
            log(_row_text(rows[-1]))
    return rows


def _one_device(data: bytes, dev: torch.device) -> tuple:
    """(the one-device exact decode, a call of it on the staged wire, the
    bits staging for the stripes, Mpix)."""
    import jpeg_decoder_tpu_torch as jt

    staged = jt.stage_host_bits(data)
    exact = jt.stage_host_bits(data, precision="exact")
    dec = jt.DeviceStreamDecoder(device=dev, host_threads=1,
                                 precision="exact")

    def call():
        return dec.decode_one(exact)

    return dec, call, staged, exact.mpix


def sweep_stripes(data: bytes, slots, dev: torch.device,
                  log=print) -> list:
    """Part 3: the stripe-bits overhead rows, one process."""
    from jpeg_decoder_tpu_torch.parallel import make_mesh
    from jpeg_decoder_tpu_torch.parallel.stripe_bits import \
        decode_bits_striped

    dec, single, staged, mpix = _one_device(data, dev)
    with dec:
        ref = single().cpu()
        rows = [dict(_row("stripes", 1, 1, single, dev, mpix, True),
                     what="one-device bits pipeline, exact")]
    log(_row_text(rows[-1]))
    t1 = rows[0]["ms"]
    for n in [s for s in slots if s >= 2]:
        mesh = make_mesh({"stripe": n}, [dev] * n)

        def call():
            return decode_bits_striped(staged, mesh)

        out = call()
        if out is None:
            rows.append({"part": "stripes", "slots": n,
                         "what": "stripe-ineligible"})
        else:
            rows.append(_row("stripes", n, 1, call, dev, mpix,
                             torch.equal(out.cpu(), ref), t1))
        log(_row_text(rows[-1]))
    return rows


def _row_text(row: dict) -> str:
    if "ms" not in row:
        return f"{row['part']:<11} slots={row['slots']:>2}  {row['what']}"
    every = row["launches_per_image"]
    return (f"{row['part']:<11} slots={row['slots']:>2} "
            f"batch={row['batch']:>3}  t={row['ms']:9.3f} ms  "
            f"{row['mpix_per_s']:9.2f} Mpix/s  launches/image "
            f"{'not measured' if every is None else f'{every:.1f}'}  "
            f"overhead t1/tN {row['overhead_t1_over_tn']:.3f}  "
            f"{'bit-equal' if row['equal'] else 'DIFFERS'}")


def sweep(data: bytes, slots=(1, 2, 4, 8), device: str = "cuda",
          batch_per_device: int = 2, log=print) -> list:
    """Every row of parts 1-3 on `device`'s slots, one process."""
    from jpeg_decoder_tpu_torch.transfer import checked_device

    dev = checked_device(device)
    log(f"-- {HEADER}")
    log("-- DP throughput and fixed-batch overhead (decode_batch_sharded)")
    rows = sweep_dp(data, slots, dev, batch_per_device, log)
    log("-- stripe-bits overhead (one image, entropy decode on the mesh)")
    return rows + sweep_stripes(data, slots, dev, log)


# ---------------------------------------------------------------------------
# --processes 2: the stripe sweep across two processes


def rank_main(rank: int, port: int, device: str, image: str, slots,
              timeout_s: float) -> int:
    """One rank of the two-process stripe sweep: N/2 slots of its device
    per mesh, its shards checked against its one-device exact decode; its
    rows as one JSON line."""
    from jpeg_decoder_tpu_torch.parallel import dist, make_mesh
    from jpeg_decoder_tpu_torch.parallel.stripe_bits import \
        decode_bits_striped
    from jpeg_decoder_tpu_torch.transfer import checked_device

    dev = checked_device(device)
    if dev.type == "cpu":       # the ranks share the cores
        torch.set_num_threads(max(1, torch.get_num_threads() // 2))
    data = Path(image).read_bytes()
    dist.init_process_mesh(rank, 2, f"tcp://127.0.0.1:{port}", timeout_s)
    try:
        dec, single, staged, mpix = _one_device(data, dev)
        with dec:
            ref = single().cpu()
            t1 = best_ms(single, dev)
        rows = []
        for n in [s for s in slots if s >= 2 and s % 2 == 0]:
            mesh = make_mesh({"stripe": n}, [dev] * (n // 2))

            def call():
                return decode_bits_striped(staged, mesh)

            shards = call()
            if shards is None:
                rows.append({"part": "stripes", "slots": n,
                             "what": "stripe-ineligible"})
                continue
            equal = all(torch.equal(s.data.cpu(), ref[s.index])
                        for s in shards)
            ms = best_ms(call, dev)
            rows.append({"part": "stripes", "processes": 2, "rank": rank,
                         "slots": n, "local_slots": n // 2, "batch": 1,
                         "ms": ms, "mpix_per_s": mpix / ms * 1e3,
                         "one_device_ms": t1, "overhead_t1_over_tn": t1 / ms,
                         "equal": equal})
    finally:
        dist.shutdown()
    print(json.dumps({"rank": rank, "rows": rows}), flush=True)
    return 0


def run_processes(image: str, slots, device: str, timeout_s: float = 300,
                  log=print) -> list:
    """The stripe sweep across two processes; every rank's rows."""
    from tools.multiproc_mesh_torch import launch_ranks

    def argv_of(rank: int, port: int) -> list:
        return [sys.executable, str(Path(__file__).resolve()), "--rank",
                str(rank), "--port", str(port), "--device", device,
                "--image", str(image), "--slots",
                ",".join(map(str, slots)), "--timeout", str(timeout_s)]

    rcs, texts = launch_ranks(argv_of, timeout_s)
    if any(rcs):
        raise RuntimeError(f"a rank failed (exit codes {rcs}):\n"
                           + "\n".join(t[-3000:] for t in texts))
    rows = []
    for text in texts:
        for line in text.splitlines():
            if line.startswith('{"rank"'):
                rows += json.loads(line)["rows"]
    log(f"-- stripe-bits overhead across 2 processes ({HEADER})")
    for row in rows:
        log(f"rank {row.get('rank')}: " + json.dumps(row))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image", default=str(DEFAULT_IMAGE))
    ap.add_argument("--batch-per-device", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="whose slots: cuda:0 (the default) or the CPU")
    ap.add_argument("--slots", default="1,2,4,8",
                    help="comma-separated slot counts")
    ap.add_argument("--processes", type=int, choices=(1, 2), default=1)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)
    slots = [int(s) for s in args.slots.split(",")]
    if args.rank is not None:
        return rank_main(args.rank, args.port, args.device, args.image,
                         slots, args.timeout)
    if args.device == "cuda":
        print("card:", card_line(), flush=True)
    if args.processes == 2:
        rows = run_processes(args.image, slots, args.device, args.timeout)
    else:
        rows = sweep(Path(args.image).read_bytes(), slots, args.device,
                     args.batch_per_device)
    print(json.dumps({"device": (torch.cuda.get_device_name(0)
                                 if args.device == "cuda" else "cpu"),
                      "rows": rows}))
    return 0 if all(r.get("equal", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""What the bits path's dispatch costs a key on its first calls, and a
stream of many keys, of one checkout, for A/B runs on a card.

    python tools/experiments/graph_traffic.py make DIR
    python tools/experiments/graph_traffic.py run TREE DIR [CASE ...]
    python tools/experiments/graph_traffic.py keys

`make` writes KEYS JPEGs into DIR (PIL, where PIL is installed; the card's
machine may lack it): this checkout's `tools/make_torch_fixtures.py`
`textured` pixels (seed 100 + i) at quality 85, 4:2:0, at distinct sizes
drawn from the ImageNet-class range of the mixed fixtures (320-500 x
240-500, seed 0), so that no two share a geometry and hence no two share
a compiled-dispatch key (`models/graphs.py`).

`run` imports the port from TREE, the root of a checkout of this
repository (this one: `.`; another commit: unpack it with `git archive
COMMIT | tar -x -C DIR2` into a directory `.gitignore` lists), and prints
one JSON line per case, on one decoder each, after a warm-up decode that
builds the kernels:

- "calls_of_a_key": every image of DIR staged first, then its first,
  second and third call of what `decode_one` runs (`_to_device`, the H2D
  landing, then `_run_device`, the device half), each timed to the card's
  end (wall ms, synchronised), with the host's median ms in each of the
  two: what a key pays before it is warm.
- "dispatch": `decode_one` over staged images back to back, one
  synchronisation at the end, wall ms/image, best of three passes: the
  images of DIR PASSES times over (more keys than a decoder's graph cache
  holds, 32: a least recently used cache then misses on every call), the
  six mixed fixtures ten times over (six keys), and tower_420 sixty-four
  times (one key).
- "stream": `decode_stream` (staging included, the decoder's default host
  threads) over the same three lists, wall ms/image, best of three.
- "groups": batches of 8, over the six mixed fixtures in GROUPS seeded
  compositions of 8 (hetero groups: one sweep and a part per size),
  tower_420 x 64 (one same-key group key) and DIR's images in groups of 8
  (each a hetero group of 8 sizes: more part keys than a decoder's 32
  graphs). Per list, PASSES + 1 passes on one decoder (the first the
  keys' first sight), each timed two ways: "stream", `decode_stream(
  batch_size=8)` with staging; "dispatch", the staged images through the
  decoder's grouping loop (`_grouped`, which calls `_decode_group`: the
  landing `_group_wires`, then `_run_group`). Each pass: wall ms/image to
  the card's end; for "dispatch" also the host's enqueue ms per group (to
  the loop's return, before the wait for the card) and the landing's host
  µs per group; after the passes the graph counts, the peak device memory
  over the list and a SHA-256 of the last pass's outputs. Run it again
  with `env JPEG_TPU_HETERO_BITS=0` on the command line for the exact-key
  grouping (the hetero threshold's question).

`keys` (host staging only, no card needed) prints one JSON line: over
every fixture under `tests/fixtures/torch_port/` (subdirectories
included), the count of distinct geometries at each precision and of the
compiled dispatch's one-image keys, `bits_key` (the images the bits
interchange stages as bits) and `prefix_key` (every image on the prefix
interchange), interleaved; and per geometry with more than one fixture,
its fixtures' residual buckets. A prefix image's key holds its residual
bucket, so images of one size can take more prefix keys than bits keys.

`CASE`s choose among "calls_of_a_key", "dispatch", "stream" and "groups"
(by default all). Each case also prints the decoder's graph counts where
TREE has them, and a SHA-256 of every output in order, which two
checkouts must share. Run parent, change, change, parent in one call to
compare two versions on one card. `run` needs a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[2]
FIXTURES = HERE / "tests" / "fixtures" / "torch_port"
KEYS = 40
PASSES = 3
GROUPS = 10     # the mixed compositions of 8 in the "groups" case
CASES = ("calls_of_a_key", "dispatch", "stream", "groups")
MIXED = ("mixed_500x375.jpg", "mixed_375x500.jpg", "mixed_500x333.jpg",
         "mixed_333x500.jpg", "mixed_448x448.jpg", "mixed_320x240.jpg")


def make(out: Path, n: int = KEYS) -> None:
    """`n` JPEGs of distinct sizes (4:2:0, quality 85), seed 0, into
    `out` as key_XX.jpg."""
    from PIL import Image

    sys.path.insert(0, str(HERE))
    from tools.make_torch_fixtures import textured

    rng = np.random.default_rng(0)
    sizes: list = []
    while len(sizes) < n:
        wh = (int(rng.integers(320, 501)), int(rng.integers(240, 501)))
        if wh not in sizes:
            sizes.append(wh)
    out.mkdir(parents=True, exist_ok=True)
    for i, (w, h) in enumerate(sizes):
        Image.fromarray(textured(h, w, 3, 3.3, 100 + i)).save(
            out / f"key_{i:02d}.jpg", "JPEG", quality=85, subsampling=2)


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def graph_stats(dec) -> dict:
    graphs = getattr(dec, "_graphs", None)
    return graphs.stats() if graphs is not None else None


def summary(ms: list) -> dict:
    return {"median_ms": statistics.median(ms), "mean_ms": statistics.mean(ms),
            "min_ms": min(ms), "max_ms": max(ms)}


def calls_of_a_key(jt, say, many: list) -> None:
    """The "calls_of_a_key" case (module docstring)."""
    with jt.DeviceStreamDecoder(host_threads=1) as dec:
        staged = [dec.stage(b) for b in many]
        calls: list = [[], [], []]
        parts: list = [([], []) for _ in range(3)]
        outs = []
        for st in staged:
            for k in range(3):
                t0 = time.perf_counter()
                wires = dec._to_device(st)
                t1 = time.perf_counter()
                out = dec._run_device(st, wires)
                t2 = time.perf_counter()
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                calls[k].append((t3 - t0) * 1e3)
                parts[k][0].append((t1 - t0) * 1e3)
                parts[k][1].append((t2 - t1) * 1e3)
            outs.append(out)
        names = ("first", "second", "third")
        say("calls_of_a_key", keys=len(many),
            **{name: summary(ms) for name, ms in zip(names, calls)},
            host_median_ms={name: {"land": statistics.median(land),
                                   "dispatch": statistics.median(run)}
                            for name, (land, run) in zip(names, parts)},
            graph=graph_stats(dec), sha256=digest(outs))


def compositions(n: int = GROUPS, size: int = 8) -> list:
    """`n` seeded compositions of `size` images of MIXED, by index."""
    rng = np.random.default_rng(0)
    return [[int(i) for i in rng.integers(0, len(MIXED), size)]
            for _ in range(n)]


def groups(jt, say, lists: dict) -> None:
    """The "groups" case (module docstring)."""
    for name, blobs in lists.items():
        with jt.DeviceStreamDecoder() as dec:
            landing = []
            group_wires = dec._group_wires

            def timed_wires(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return group_wires(*args, **kw)
                finally:
                    landing.append(time.perf_counter() - t0)
            dec._group_wires = timed_wires
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            stream_ms, dispatch, outs = [], [], None
            staged = [dec.stage(b) for b in blobs]
            for _pass in range(PASSES + 1):
                t0 = time.perf_counter()
                dec.decode_stream(blobs, batch_size=8)
                torch.cuda.synchronize()
                stream_ms.append((time.perf_counter() - t0) * 1e3
                                 / len(blobs))
                landing.clear()
                t0 = time.perf_counter()
                outs = dec._grouped(iter(staged), 8)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                n = max(len(landing), 1)
                dispatch.append({
                    "ms_per_image": (t2 - t0) * 1e3 / len(blobs),
                    "enqueue_ms_per_group": (t1 - t0) * 1e3 / n,
                    "landing_us_per_group": sum(landing) * 1e6 / n,
                    "groups": len(landing)})
            peak = torch.cuda.max_memory_allocated() - base
            say("groups", list=name, images=len(blobs),
                stream_ms_per_image=stream_ms, dispatch=dispatch,
                graph=graph_stats(dec), peak_bytes=peak,
                hetero_bits=os.environ.get("JPEG_TPU_HETERO_BITS"),
                sha256=digest(outs))


def keys() -> dict:
    """The `keys` subcommand's counts (module docstring)."""
    sys.path.insert(0, str(HERE))
    from jpeg_decoder_tpu_torch import stage_host_bits
    from jpeg_decoder_tpu_torch.host.staging import stage_host
    from jpeg_decoder_tpu_torch.models import graphs
    from jpeg_decoder_tpu_torch.models.stream import StagedBits

    names = sorted(str(p.relative_to(FIXTURES))
                   for p in FIXTURES.rglob("*.jpg"))
    out = {"fixtures": len(names)}
    for precision in ("fast", "exact"):
        bits, prefix, geometries = set(), set(), {}
        for name in names:
            data = (FIXTURES / name).read_bytes()
            st = stage_host_bits(data, None, precision)
            if isinstance(st, StagedBits):
                bits.add(graphs.bits_key(st, precision, "interleaved"))
            pre = stage_host(data, None, precision)
            prefix.add(graphs.prefix_key(pre, precision, "interleaved"))
            geometries.setdefault(pre.geometry, {})[name] = \
                len(pre.resid_idx)
        out[precision] = {
            "geometries": len(geometries), "bits_keys": len(bits),
            "prefix_keys": len(prefix),
            "shared_geometries": [buckets for buckets in geometries.values()
                                  if len(buckets) > 1]}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "make":
        make(Path(argv[1]))
        return 0
    if argv == ["keys"]:
        print(json.dumps(keys()))
        return 0
    cases = argv[3:] or list(CASES)
    if len(argv) < 3 or argv[0] != "run" or set(cases) - set(CASES) \
            or not torch.cuda.is_available():
        print("usage: graph_traffic.py make DIR | run TREE DIR [CASE ...] "
              f"| keys (CASE in {CASES}; run needs a CUDA device)",
              file=sys.stderr)
        return 1
    many = [p.read_bytes() for p in sorted(Path(argv[2]).glob("key_*.jpg"))]
    mixed = [(FIXTURES / n).read_bytes() for n in MIXED]
    tower = (FIXTURES / "tower_420.jpg").read_bytes()
    tree = Path(argv[1]).resolve()
    sys.path.insert(0, str(tree))
    for name in [m for m in sys.modules
                 if m.startswith(("jpeg_decoder_tpu", "tools"))]:
        del sys.modules[name]
    import jpeg_decoder_tpu_torch as jt

    def say(case: str, **fields) -> None:
        print(json.dumps({"tree": argv[1], "case": case, **fields}),
              flush=True)

    with jt.DeviceStreamDecoder(host_threads=1) as dec:
        dec.decode_stream([tower] * 3)
        torch.cuda.synchronize()

    if "groups" in cases:
        groups(jt, say, {
            "mixed": [mixed[i] for comp in compositions() for i in comp],
            "tower_420": [tower] * 64, "many_keys": many})
    if "calls_of_a_key" in cases:
        calls_of_a_key(jt, say, many)
    lists = {"many_keys": many * PASSES, "mixed": mixed * 10,
             "tower_420": [tower] * 64}
    if "dispatch" in cases:
        for name, blobs in lists.items():
            with jt.DeviceStreamDecoder(host_threads=1) as dec:
                staged = [dec.stage(b) for b in blobs]
                dec.decode_one(staged[0])
                torch.cuda.synchronize()
                best, outs = None, None
                for _rep in range(3):
                    t0 = time.perf_counter()
                    got = [dec.decode_one(st) for st in staged]
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3 / len(staged)
                    if best is None or ms < best:
                        best, outs = ms, got
                say("dispatch", stream=name, images=len(staged),
                    ms_per_image=best, graph=graph_stats(dec),
                    sha256=digest(outs))
    if "stream" in cases:
        for name, blobs in lists.items():
            with jt.DeviceStreamDecoder() as dec:
                dec.decode_stream(blobs[:1])
                torch.cuda.synchronize()
                best, outs = None, None
                for _rep in range(3):
                    t0 = time.perf_counter()
                    got = dec.decode_stream(blobs)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3 / len(blobs)
                    if best is None or ms < best:
                        best, outs = ms, got
                say("stream", stream=name, images=len(blobs),
                    ms_per_image=best, graph=graph_stats(dec),
                    sha256=digest(outs))
    return 0


if __name__ == "__main__":
    sys.exit(main())

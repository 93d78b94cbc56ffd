#!/usr/bin/env python
"""Multi-process mesh harness of the PyTorch port: 2 OS processes x 4 local
slots = one 8-entry global mesh over torch.distributed (gloo over TCP on
127.0.0.1). The counterpart of tools/multiproc_mesh.py (jax.distributed):
the seams that break a decode spread over processes are staging each
process's own rows into a global batch, and the halo and the DC seam carry
crossing the process boundary.

Each rank drives 4 slots of its device (["cuda:0"] * 4: two CUDA contexts
on one card, every exchange between them staged through host memory; or
with --device cpu, ["cpu"] * 4) and holds its own shards bit for bit against
the same decode in its own process:

  1. DP over "data"=8: the example 4:2:0 geometry (parallel/dryrun.py),
     batch 8, seed 7, through make_batch_pipeline with rows_of, so a rank
     stages only its own rows; oracle: the host copy's numpy _reconstruct.
  2. SP over "stripe"=8: the example geometry at 16 MCU rows, seed 3,
     through make_stripe_pipeline: the V2 halo crosses the seam between
     stripes 3 and 4; oracle: _reconstruct.
  3. Real JPEGs in a data-axis group with process-local staging:
     tower_420.jpg and tower_420_q92.jpg alternating over 16 rows, each rank
     staging only its shards' rows; the prefix interchange at precision
     "exact", then the bits interchange at "fast" (K1 once per data shard,
     K2 once per plan of a shard); oracle: the meshless DeviceStreamDecoder.
  4. Lossless DP: eight 512 x 512 16-bit SOF3 streams at predictor 6
     (seeds 0-7), each rank making and staging only its rows (L1 once per
     data shard on a card); oracle: the host decode.
  5. The entropy-included stripes over "stripe"=8 through
     DeviceStreamDecoder.decode_striped: large_420.jpg (105 MCU rows: 7
     stripes of 14 and a short last one) and stripe_420.jpg (stripes whose
     first block is negative); the DC seam carry and the halo cross the
     process seam; oracle: the host exact decode. On a card each rank also
     holds K1 against its plain version on its own stripe wires, and times
     the striped large_420 decode with CUDA events.

Each rank prints its verdicts, then "MULTIPROC-MESH-TORCH OK", then one
JSON line: per phase bit-equality, ms (host clock around the phase, device
synchronised), the kernels' launch counts, the bytes CROSSED (received from
the other rank) and EXCHANGED (every exchange's bytes into this rank's
tensors), and the rows it staged. With --dump DIR each rank also writes its
shards to DIR/rank<R>.npz (`<phase>/<i>/data` and `<phase>/<i>/index`, the
index as [start, stop] per axis).

Usage:
  python tools/multiproc_mesh_torch.py [--device cuda|cpu] [--dump DIR]
                                       [--timeout SECONDS]
  python tools/multiproc_mesh_torch.py --rank R --port P ...   # one rank

The parent exits nonzero when a rank fails, times out, or cannot join the
group; a port taken between choosing it and binding it is tried once more.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jpeg_decoder_tpu_torch as jt  # noqa: E402
from jpeg_decoder_tpu_torch.entropy.chunk_decode import (  # noqa: E402
    decode_chunks, decode_chunks_plain)
from jpeg_decoder_tpu_torch.host.decoder import \
    Decoder as HostDecoder  # noqa: E402
from jpeg_decoder_tpu_torch.host.ops.pipeline import \
    _reconstruct  # noqa: E402
from jpeg_decoder_tpu_torch.parallel import (  # noqa: E402
    dist, make_batch_pipeline, make_mesh, make_stripe_pipeline)
from jpeg_decoder_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from jpeg_decoder_tpu_torch.parallel.dist import Remote  # noqa: E402
from jpeg_decoder_tpu_torch.parallel.dryrun import (  # noqa: E402
    _example_geometry, _example_inputs)
from jpeg_decoder_tpu_torch.parallel.mesh import \
    local_positions  # noqa: E402
from jpeg_decoder_tpu_torch.parallel.stripe_bits import (  # noqa: E402
    decode_bits_striped, split_anchored_stripes, stripe_wire)
from jpeg_decoder_tpu_torch.parallel.stripes import _pad_rows  # noqa: E402
from tools.make_torch_fixtures import sof3_jpeg, sof3_samples  # noqa: E402

N_PROCS = 2
LOCAL_SLOTS = 4
MARK = "MULTIPROC-MESH-TORCH OK"
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_port")
TOWERS = ("tower_420.jpg", "tower_420_q92.jpg")
TOWER_ROWS = 16
SOF3_ROWS = 8
SOF3_SLICE = (512, 512)
STRIPED = ("large_420.jpg", "stripe_420.jpg")
# What a rank must not inherit from the process that starts it: another
# process group's rendezvous, and the JAX settings of a test run.
INHERITED = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
             "LOCAL_WORLD_SIZE", "GROUP_RANK", "JAX_PLATFORMS", "XLA_FLAGS",
             "PYTHONPATH")


# ---------------------------------------------------------------------------
# Child
# ---------------------------------------------------------------------------

def _read(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


class Rank:
    """One rank's run: its slots, the phases' records and the shards to
    dump."""

    def __init__(self, rank: int, device: str):
        self.rank = rank
        self.cuda = device == "cuda"
        self.slots = [("cuda:0" if self.cuda else "cpu")] * LOCAL_SLOTS
        self.records: dict = {}
        self.dumped: dict = {}

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def run(self, name: str, fn, **extra):
        """fn() with the launch and exchange counts set to 0 just before
        and read just after; returns its result and records the phase."""
        self.sync()
        jt.reset_launches()
        mesh_mod.reset_exchanged()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        self.records[name] = {
            "ms": (time.perf_counter() - t0) * 1e3,
            "launches": dict(jt.LAUNCHES),
            "crossed": dict(mesh_mod.CROSSED),
            "exchanged": dict(mesh_mod.EXCHANGED), **extra}
        return out

    def check(self, name: str, got: list, want) -> None:
        """Each (index, data) of this rank equal to want[index] (or
        want(index)), bit for bit; marks the phase equal and keeps the
        shards for --dump."""
        if not got:
            raise AssertionError(f"{name}: rank {self.rank} holds nothing")
        for index, data in got:
            data = data.cpu().numpy()
            ref = np.asarray(want(index) if callable(want) else want[index])
            if data.shape != ref.shape or not np.array_equal(data, ref):
                bad = (int((data != ref).sum()) if data.shape == ref.shape
                       else f"shape {data.shape} vs {ref.shape}")
                raise AssertionError(f"{name}: rank {self.rank} shard "
                                     f"{index} differs ({bad})")
            self.dumped.setdefault(name, []).append((index, data))
        self.records[name]["equal"] = True
        self.records[name]["shards"] = [[[s.start, s.stop] for s in index]
                                        for index, _ in got]
        print(f"[rank {self.rank}] {name}: {len(got)} shards bit-equal",
              flush=True)

    def dump(self, path: str) -> None:
        arrays = {}
        for name, shards in self.dumped.items():
            for i, (index, data) in enumerate(shards):
                arrays[f"{name}/{i}/data"] = data
                arrays[f"{name}/{i}/index"] = np.array(
                    [[s.start, s.stop] for s in index], np.int64)
        np.savez(os.path.join(path, f"rank{self.rank}.npz"), **arrays)


def _shards(shards) -> list:
    return [(s.index, s.data) for s in shards]


def _local_images(images) -> list:
    """A group's images this rank decoded, as (index, [1, ...] data)."""
    return [((slice(i, i + 1),), img[None]) for i, img in enumerate(images)
            if not isinstance(img, Remote)]


def _rows(index) -> range:
    return range(index[0].start, index[0].stop)


def phase_dp(r: Rank) -> None:
    """1. DP over "data"=8 with process-local staging."""
    mesh = make_mesh({"data": N_PROCS * LOCAL_SLOTS}, r.slots)
    geometry = _example_geometry()
    batch = N_PROCS * LOCAL_SLOTS
    stores, qts = _example_inputs(geometry, batch=batch, seed=7)
    staged = []

    def rows_of(b0, b1):
        staged.extend(range(b0, b1))
        return tuple(s[b0:b1] for s in stores)

    fn = make_batch_pipeline(geometry, mesh, "data")
    out = r.run("1 dp", lambda: fn(rows_of, qts, batch=batch),
                staged_rows=staged)
    oracle = np.stack([_reconstruct(geometry, [s[i] for s in stores], qts,
                                    np) for i in range(batch)])
    r.check("1 dp", _shards(out), oracle)


def phase_sp(r: Rank) -> None:
    """2. SP over "stripe"=8: the halo crosses the process seam."""
    sp = N_PROCS * LOCAL_SLOTS
    mesh = make_mesh({"stripe": sp}, r.slots)
    geometry = _example_geometry(mcu_rows=2 * sp)
    mcu_rows = geometry.components[0].blocks_high // 2
    stores, qts = _example_inputs(geometry, seed=3)
    fn = make_stripe_pipeline(geometry, mcu_rows, sp, mesh, "stripe")
    out = r.run("2 sp", lambda: fn(
        _pad_rows(geometry, stores, mcu_rows, sp, False), qts))
    r.check("2 sp", _shards(out), _reconstruct(geometry, stores, qts, np))


def _group(r: Rank, dec, n: int, source_of) -> tuple:
    """A group of n rows on `dec`'s mesh with process-local staging: this
    rank stages the rows of its own shards (`source_of(i)` gives row i's
    bytes), and every other row is `Remote(owner)`. Returns (the group,
    the rows staged here)."""
    group, staged = [None] * n, []
    for _dev, owner, (b0, b1) in dec.mesh_shards(n):
        for i in range(b0, b1):
            if owner == r.rank:
                group[i] = dec.stage(source_of(i))
                staged.append(i)
            else:
                group[i] = Remote(owner)
    return group, staged


def phase_towers(r: Rank) -> None:
    """3. tower_420 and its q92 variant alternating over 16 rows: a prefix
    group at "exact", then a bits group at "fast"."""
    mesh = make_mesh({"data": N_PROCS * LOCAL_SLOTS}, r.slots)
    blobs = [_read(name) for name in TOWERS]
    for interchange, precision in (("prefix", "exact"), ("bits", "fast")):
        kw = {"interchange": interchange, "precision": precision,
              "host_threads": 2}
        with jt.DeviceStreamDecoder(device=r.slots[0], **kw) as plain:
            want = [plain.decode_one(plain.stage(b)).cpu().numpy()
                    for b in blobs]
        name = f"3 {interchange}"
        with jt.DeviceStreamDecoder(mesh=mesh, **kw) as dec:
            mine = [rows for _dev, owner, rows in dec.mesh_shards(TOWER_ROWS)
                    if owner == r.rank]
            staged, plans = [], []

            def decode():
                group, rows = _group(r, dec, TOWER_ROWS,
                                     lambda i: blobs[i % len(blobs)])
                staged.extend(rows)
                if interchange == "bits":   # K2 runs once per plan
                    plans.extend(len({group[i].scans[0].scan.plan
                                      for i in range(b0, b1)})
                                 for b0, b1 in mine)
                return dec._decode_group_mesh(interchange, group)

            out = r.run(name, decode, staged_rows=staged,
                        precision=precision, local_shards=len(mine),
                        plans_per_shard=plans)
        r.check(name, _local_images(out),
                lambda index: [want[i % len(want)] for i in _rows(index)])


def phase_lossless(r: Rank) -> None:
    """4. Lossless DP: eight 512 x 512 16-bit SOF3 slices at predictor 6."""
    mesh = make_mesh({"data": N_PROCS * LOCAL_SLOTS}, r.slots)
    with jt.DeviceStreamDecoder(mesh=mesh, host_threads=2) as dec:
        # The streams of this rank's rows only, made before the timing:
        # making data is set-up.
        blobs = {i: sof3_jpeg(sof3_samples(*SOF3_SLICE, 1, 16, 0, seed=i),
                              6, 0, 16)
                 for _dev, owner, (b0, b1) in dec.mesh_shards(SOF3_ROWS)
                 if owner == r.rank for i in range(b0, b1)}
        staged = []

        def decode():
            group, rows = _group(r, dec, SOF3_ROWS, blobs.__getitem__)
            staged.extend(rows)
            return dec._decode_group_mesh("lossless", group)

        out = r.run("4 lossless", decode, staged_rows=staged)
    want = {i: HostDecoder(b, backend="numpy", precision="exact")
            .decode_array() for i, b in blobs.items()}
    r.check("4 lossless", _local_images(out),
            lambda index: [want[i] for i in _rows(index)])


def _k1_on_own_wires(mesh, staged, mine: list) -> tuple:
    """K1 against its plain version on this rank's own stripe wires of
    `staged`: (the largest difference, the wires whose first block is
    negative)."""
    scan = staged.scans[0].scan
    split = split_anchored_stripes(scan, mesh.shape["stripe"])
    params = mesh.params(mesh.first)
    err, negative = 0, 0
    for d in mine:
        arrays, s_max = stripe_wire(split, d)
        args = tuple(torch.from_numpy(a).to(mesh.first) for a in arrays) + (
            params.tables(scan), s_max, split.n_blocks_local)
        err = max(err, int((decode_chunks(*args).to(torch.int32)
                            - decode_chunks_plain(*args).to(torch.int32))
                           .abs().max()))
        negative += int(len(arrays[3]) > 0 and arrays[3][0] < 0)
    return err, negative


def phase_striped(r: Rank) -> None:
    """5. The entropy-included stripes over "stripe"=8."""
    sp = N_PROCS * LOCAL_SLOTS
    mesh = make_mesh({"stripe": sp}, r.slots)
    mine = local_positions(mesh.axis_owners("stripe"))
    for fixture in STRIPED:
        blob = _read(fixture)
        name = f"5 {fixture[:-4]}"
        with jt.DeviceStreamDecoder(mesh=mesh, host_threads=2) as dec:
            out = r.run(name, lambda: dec.decode_striped(blob),
                        stripes=mine)
        r.check(name, _shards(out), HostDecoder(
            blob, backend="numpy", precision="exact").decode_array())
        if not r.cuda:
            continue
        # On the card: K1 against its plain version on this rank's own
        # stripe wires, and the striped decode's time, wire staged.
        staged = jt.stage_host_bits(blob)
        err, negative = _k1_on_own_wires(mesh, staged, mine)
        if err:
            raise AssertionError(f"{name}: rank {r.rank} K1 differs from "
                                 f"plain on its stripe wires by {err}")
        reps = 5
        decode_bits_striped(staged, mesh)              # warm
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            decode_bits_striped(staged, mesh)
        stop.record()
        stop.synchronize()
        r.records[name].update(
            k1_vs_plain_on_own_stripe_wires=err,
            own_wires_with_negative_first_block=negative,
            cuda_event_ms_per_image=start.elapsed_time(stop) / reps)


def child(rank: int, port: int, device: str, dump: str,
          timeout_s: float) -> None:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is "
                           "False")
    if device == "cpu":     # the ranks share the cores
        torch.set_num_threads(max(1, torch.get_num_threads() // N_PROCS))
    dist.init_process_mesh(rank, N_PROCS, f"tcp://127.0.0.1:{port}",
                           timeout_s)
    try:
        r = Rank(rank, device)
        for phase in (phase_dp, phase_sp, phase_towers, phase_lossless,
                      phase_striped):
            phase(r)
        if dump:
            r.dump(dump)
    finally:
        dist.shutdown()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib",
                                           "jpeg_decoder_tpu"))
    if loaded:
        raise AssertionError(f"rank {rank} imported {loaded[:5]}")
    print(f"[rank {rank}] {MARK}", flush=True)
    print(json.dumps({
        "rank": rank, "processes": N_PROCS, "local_slots": r.slots,
        "device": (torch.cuda.get_device_name(0) if r.cuda else "cpu"),
        "phases": r.records}), flush=True)


# ---------------------------------------------------------------------------
# Parent
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(argv_of, timeout_s: float, n: int = N_PROCS) -> tuple:
    """Start n ranks, rank r as `argv_of(r, port)` (a fresh interpreter
    each, in the repository, with PYTHONPATH at it and nothing of INHERITED
    from this process), and wait for all of them, at most `timeout_s`
    seconds; a rank that fails stops the others. A port taken between
    choosing it and binding it is tried once more. Returns (each rank's
    exit code, each rank's output)."""
    env = {k: v for k, v in os.environ.items()
           if k not in INHERITED and not k.startswith("TORCHELASTIC_")}
    env["PYTHONPATH"] = REPO
    for attempt in range(2):
        port = _free_port()
        procs, logs = [], []
        for rank in range(n):
            logs.append(tempfile.TemporaryFile())
            procs.append(subprocess.Popen(
                argv_of(rank, port), env=env, cwd=REPO, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.1)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read().decode(errors="replace"))
            log.close()
        rcs = [p.returncode for p in procs]
        taken = any("EADDRINUSE" in t or "Address already in use" in t
                    for t in texts)
        if attempt or not (any(rcs) and taken):
            return rcs, texts


def parent(args) -> int:
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)

    def argv_of(rank: int, port: int) -> list:
        argv = [sys.executable, os.path.abspath(__file__), "--rank",
                str(rank), "--port", str(port), "--device", args.device,
                "--timeout", str(args.timeout)]
        return argv + (["--dump", args.dump] if args.dump else [])

    rcs, texts = launch_ranks(argv_of, args.timeout)
    for text in texts:
        sys.stdout.write(text)
    ok = all(rc == 0 and MARK in t for rc, t in zip(rcs, texts))
    print("multiproc_mesh_torch:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="each rank's 4 slots: cuda:0 (the default) or the "
                         "CPU")
    ap.add_argument("--dump", default=None,
                    help="directory for each rank's shards (rank<R>.npz)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds for the whole run, and for any wait of "
                         "one rank on another")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args()
    if args.rank is None:
        return parent(args)
    child(args.rank, args.port, args.device, args.dump, args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())

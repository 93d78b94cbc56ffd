"""The port's mesh across processes (`tools/multiproc_mesh_torch.py`: two
gloo ranks x 4 CPU slots, one mesh of 8), against the JAX package in this
process. The harness runs once, with `--dump`; each rank's shards are then
held against the JAX package's result for the same seeded inputs:

- phases 1 (DP, batch 8, seed 7) and 2 (SP over 8 stripes, seed 3):
  `jpeg_decoder_tpu.ops.pipeline._reconstruct` (jnp) on
  `__graft_entry__._example_inputs`, bit for bit;
- phase 3, tower_420 and tower_420_q92 alternating over 16 rows: the
  prefix group at "exact" bit-equal to `jpeg_decoder_tpu.Decoder(
  backend="numpy", precision="exact")`, the bits group at "fast" within 3
  of it (the reference's fast-tier contract);
- phase 4, eight 512 x 512 16-bit SOF3 streams at predictor 6, and phase
  5, large_420 and stripe_420 striped over 8 with entropy decode: bit-equal
  to the same JAX decoder.

Every shard the two ranks hold covers the result once. Phases 1, 3 and 4
stage only each rank's own rows and move nothing between processes; in
phases 2 and 5 the halo (and in 5 the DC carry) crosses the seam between
stripes 3 and 4, by exactly the bytes the shapes give.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as ge
from jpeg_decoder_tpu import Decoder as RefDecoder
from jpeg_decoder_tpu.ops.pipeline import _reconstruct
from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

REPO = Path(__file__).resolve().parent.parent
HARNESS = REPO / "tools" / "multiproc_mesh_torch.py"
FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
RANKS = (0, 1)
PHASES = ("1 dp", "2 sp", "3 prefix", "3 bits", "4 lossless",
          "5 large_420", "5 stripe_420")
FAST_TOL = 3


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(each rank's JSON report, each rank's dumped shards by phase)."""
    dump = tmp_path_factory.mktemp("multiproc_dump")
    res = subprocess.run(
        [sys.executable, str(HARNESS), "--device", "cpu", "--dump",
         str(dump), "--timeout", "100"],
        cwd=REPO, capture_output=True, text=True, timeout=110,
        # One thread per rank: the workers of the test run share the cores.
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stdout[-6000:] + res.stderr[-3000:]
    reports = {}
    for line in res.stdout.splitlines():
        if line.startswith('{"rank"'):
            rep = json.loads(line)
            reports[rep["rank"]] = rep
    assert sorted(reports) == list(RANKS), res.stdout[-3000:]
    assert res.stdout.count("MULTIPROC-MESH-TORCH OK") == len(RANKS)
    shards = {}
    for rank in RANKS:
        with np.load(dump / f"rank{rank}.npz") as z:
            by_phase = {}
            for key in z.files:
                phase, i, field = key.split("/")
                by_phase.setdefault(phase, {}).setdefault(int(i), {})[
                    field] = z[key]
            shards[rank] = {
                phase: [(tuple(slice(int(a), int(b)) for a, b in
                               entry["index"]), entry["data"])
                        for _, entry in sorted(items.items())]
                for phase, items in by_phase.items()}
    return reports, shards


def _example(phase: str) -> np.ndarray:
    if phase == "1 dp":
        geometry = ge._example_geometry()
        stores, qts = ge._example_inputs(geometry, batch=8, seed=7)
        return np.stack([np.asarray(_reconstruct(
            geometry, [s[i] for s in stores], qts, jnp)) for i in range(8)])
    geometry = ge._example_geometry(mcu_rows=16)
    stores, qts = ge._example_inputs(geometry, seed=3)
    return np.asarray(_reconstruct(geometry, stores, qts, jnp))


def _exact(data: bytes) -> np.ndarray:
    return RefDecoder(data, backend="numpy", precision="exact").decode_array()


def _reference(phase: str) -> np.ndarray:
    """The JAX package's result for the phase's whole global array."""
    if phase in ("1 dp", "2 sp"):
        return _example(phase)
    if phase.startswith("3 "):
        towers = [_exact((FIXTURES / n).read_bytes())
                  for n in ("tower_420.jpg", "tower_420_q92.jpg")]
        return np.stack([towers[i % 2] for i in range(16)])
    if phase == "4 lossless":
        return np.stack([_exact(sof3_jpeg(sof3_samples(512, 512, 1, 16, 0,
                                                       seed=i), 6, 0, 16))
                         for i in range(8)])
    return _exact((FIXTURES / f"{phase[2:]}.jpg").read_bytes())


def _covered(shards: dict, phase: str, rows: int) -> list:
    """The first axis's [start, stop) of every shard of both ranks, each
    row once, and all rows."""
    spans = sorted((index[0].start, index[0].stop)
                   for rank in RANKS for index, _ in shards[rank][phase])
    assert spans[0][0] == 0 and spans[-1][1] == rows, spans
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:])), spans
    return spans


@pytest.mark.parametrize("phase", PHASES)
def test_shards_equal_the_jax_package(run, phase):
    reports, shards = run
    want = _reference(phase)
    _covered(shards, phase, want.shape[0])
    tol = FAST_TOL if phase == "3 bits" else 0
    for rank in RANKS:
        assert reports[rank]["phases"][phase]["equal"] is True
        for index, data in shards[rank][phase]:
            ref = want[index]
            assert data.shape == ref.shape, (rank, index)
            diff = np.abs(data.astype(np.int64) - ref.astype(np.int64))
            assert int(diff.max()) <= tol, (phase, rank, index,
                                            int(diff.max()))


@pytest.mark.parametrize("phase", ("1 dp", "3 prefix", "3 bits",
                                   "4 lossless"))
def test_each_rank_stages_only_its_own_rows(run, phase):
    """The staging function ran once per row of this rank's shards and no
    other, and no store or wire crossed between the processes."""
    reports, shards = run
    staged = {}
    for rank in RANKS:
        rec = reports[rank]["phases"][phase]
        own = sorted(i for index, _ in shards[rank][phase]
                     for i in range(index[0].start, index[0].stop))
        assert sorted(rec["staged_rows"]) == own, (rank, rec["staged_rows"])
        assert rec["crossed"] == {"halo": 0, "carry": 0, "gather": 0}
        staged[rank] = set(own)
    assert not staged[0] & staged[1]
    assert staged[0] | staged[1] == set(range(max(staged[1]) + 1))


def test_the_halo_crosses_the_process_seam_in_the_store_stripes(run):
    """Phase 2: 8 stripes of the example geometry, 4 per rank. Each rank
    receives one row of each V2 chroma plane from across the seam (64
    columns of uint8), and nothing else crosses."""
    reports, _ = run
    geometry = ge._example_geometry(mcu_rows=16)
    row = sum(c.blocks_wide * 8 for c in geometry.components
              if c.upsampler_mode == "h2v2")
    for rank in RANKS:
        rec = reports[rank]["phases"]["2 sp"]
        assert rec["crossed"] == {"halo": row, "carry": 0, "gather": 0}
        # Every other halo row is a copy between this rank's own slots.
        assert rec["exchanged"]["halo"] == 7 * row


@pytest.mark.parametrize("fixture,width,rows", [("large_420", 2048, 1680),
                                                ("stripe_420", 648, 488)])
def test_the_halo_and_carry_cross_the_seam_in_the_entropy_stripes(
        run, fixture, width, rows):
    """Phase 5: each rank gets one chroma row per component from across the
    seam (large_420: 2 x 1,024 B each way, 4,096 B in all), and rank 1 the
    int64 DC totals of rank 0's four stripes (4 x 3 components x 8 B = 96
    B, under the 384 B of one copy per stripe pair); large_420's short
    last stripe (7 of 14 MCU rows) is on rank 1."""
    reports, shards = run
    chroma_row = -(-width // 16) * 8          # plane columns, whole blocks
    phase = f"5 {fixture}"
    crossed = {rank: reports[rank]["phases"][phase]["crossed"]
               for rank in RANKS}
    for rank in RANKS:
        assert crossed[rank]["halo"] == 2 * chroma_row
        assert crossed[rank]["gather"] == 0
    assert crossed[0]["carry"] == 0 and crossed[1]["carry"] == 4 * 3 * 8
    assert sum(c["halo"] for c in crossed.values()) == 4 * chroma_row
    assert reports[1]["phases"][phase]["stripes"] == [4, 5, 6, 7]
    spans = _covered(shards, phase, rows)
    last = spans[-1]
    assert last in [(i[0].start, i[0].stop) for i, _ in shards[1][phase]]
    if fixture == "large_420":
        assert chroma_row * 4 == 4096
        assert last == (1568, 1680)           # 7 MCU rows of 16

"""The process group of the port's mesh (`jpeg_decoder_tpu_torch.parallel.
dist`) and the exchanges across it (`parallel.mesh`):

- two gloo ranks, spawned once, each holding 4 of the 8 stripes of a mesh
  {"stripe": 8} built across them (`make_mesh` under the group): the
  ranks' `owners`, then `halo_rows`, `exclusive_carry` and `gather_rows`
  on seeded tensors at large_420's shapes (chroma planes [1, 112, 1024]
  uint8, DC totals [1, 3] int64 far outside int32, output rows [1, 224,
  ...] with a short last stripe), each rank passing only its own stripes:
  the values against numpy on the same seeds, and `CROSSED` equal to the
  bytes counted from the shapes (large_420 at 8 stripes: 4,096 B of halo
  at the seam in all, 96 B of carry, under the 384 B of one copy per
  stripe pair); several messages each way between one pair in one round;
  and `dryrun_multichip(8, ["cpu"] * 4)` across the two ranks;
- a rank that raises fails the launch at once, with its exit code;
- in this process, without a process group: a mesh has every owner 0 and
  behaves as before (the exchanges with and without owners give the same
  tensors and bytes, nothing counted as crossed), and
  `BatchDecodeService` refuses a mesh across processes.
"""

import json
import sys

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu_torch import BatchDecodeService
from jpeg_decoder_tpu_torch.parallel import Mesh, make_mesh
from jpeg_decoder_tpu_torch.parallel import dist as pdist
from jpeg_decoder_tpu_torch.parallel import mesh as mesh_mod
from tools.multiproc_mesh_torch import launch_ranks

STRIPES = 8
PLANE = (1, 112, 1024)          # large_420's chroma plane per stripe
ROWS = (1, 224, 16, 3)          # a stripe's output rows (narrowed)
LAST_ROWS = 112                 # large_420's short last stripe


def planes(d: int) -> np.ndarray:
    return np.random.default_rng(d).integers(0, 256, PLANE, dtype=np.uint8)


def totals(d: int) -> np.ndarray:
    return np.random.default_rng(100 + d).integers(
        -2 ** 40, 2 ** 40, (1, 3), dtype=np.int64)


def rows(d: int) -> np.ndarray:
    shape = (*ROWS[:1], LAST_ROWS if d == STRIPES - 1 else ROWS[1],
             *ROWS[2:])
    return np.random.default_rng(200 + d).integers(0, 256, shape,
                                                   dtype=np.uint8)


RANK_SCRIPT = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, "tests")
from test_torch_dist import planes, rows, totals, STRIPES
from jpeg_decoder_tpu_torch.parallel import dist, make_mesh
from jpeg_decoder_tpu_torch.parallel import mesh as mesh_mod
from jpeg_decoder_tpu_torch.parallel.dryrun import dryrun_multichip
from jpeg_decoder_tpu_torch.parallel.mesh import local_positions

rank, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_mesh(rank, 2, f"tcp://127.0.0.1:{port}", 60)
mesh = make_mesh({"stripe": STRIPES}, ["cpu"] * 4)
owners = mesh.axis_owners("stripe")
mine = local_positions(owners)
report = {"rank": rank, "owners": mesh.owners.tolist(),
          "processes": mesh.processes, "mesh_rank": mesh.rank,
          "mine": mine, "first": str(mesh.first)}
saved = {}


def counted(name, fn):
    mesh_mod.reset_exchanged()
    out = fn()
    report[name] = {"crossed": dict(mesh_mod.CROSSED),
                    "exchanged": dict(mesh_mod.EXCHANGED)}
    return out


halos = counted("halo", lambda: mesh_mod.halo_rows(
    [torch.from_numpy(planes(d)) for d in mine], owners))
carries = counted("carry", lambda: mesh_mod.exclusive_carry(
    [torch.from_numpy(totals(d)) for d in mine], owners))
whole = counted("gather", lambda: mesh_mod.gather_rows(
    [torch.from_numpy(rows(d)) for d in mine], torch.device("cpu"), dim=1,
    owners=owners))
for d, (top, bot), carry in zip(mine, halos, carries):
    saved[f"top{d}"], saved[f"bot{d}"] = top.numpy(), bot.numpy()
    saved[f"carry{d}"] = carry.numpy()
saved["whole"] = whole.numpy()

# Several messages each way between one pair in one round, posted in the
# same global order on both ranks.
ex = dist.Transport()
got = []
for k in range(3):
    for src in (0, 1):
        t = torch.full((k + 1,), 10 * src + k, dtype=(torch.int16, torch.int64,
                                                     torch.uint8)[k])
        if src == rank:
            ex.send_to(t, 1 - rank)
        else:
            got.append(ex.recv_from(t.shape, t.dtype, src, "cpu"))
report["ring"] = [r.tolist() for r in (ex.run()[i] for i in got)]
report["dryrun"] = dryrun_multichip(8, ["cpu"] * 4)
dist.shutdown()
np.savez(f"{out_dir}/rank{rank}.npz", **saved)
print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    rcs, texts = launch_ranks(
        lambda r, port: [sys.executable, "-c", RANK_SCRIPT, str(r),
                         str(port), str(out)], timeout_s=90)
    assert rcs == [0, 0], "\n".join(t[-3000:] for t in texts)
    reports = [json.loads(t.strip().splitlines()[-1]) for t in texts]
    saved = [dict(np.load(out / f"rank{r}.npz")) for r in (0, 1)]
    return reports, saved


def test_the_mesh_spans_both_ranks_in_rank_order(ranks):
    reports, _ = ranks
    for r, rep in enumerate(reports):
        assert rep["owners"] == [0] * 4 + [1] * 4
        assert rep["processes"] == 2 and rep["mesh_rank"] == r
        assert rep["mine"] == list(range(4 * r, 4 * r + 4))
        assert rep["first"] == "cpu"


def test_halo_rows_across_ranks(ranks):
    """Each stripe's top is the last row of the stripe above and its
    bottom the first row of the stripe below, zeros at the image's ends,
    whichever rank holds the neighbour; the seam's rows cross once each
    way: 1,024 B per rank, 4,096 B for large_420's two chroma planes."""
    reports, saved = ranks
    zero = np.zeros((1, 1, PLANE[2]), np.uint8)
    for r in (0, 1):
        for d in reports[r]["mine"]:
            want_top = planes(d - 1)[:, -1:] if d else zero
            want_bot = planes(d + 1)[:, :1] if d + 1 < STRIPES else zero
            assert np.array_equal(saved[r][f"top{d}"], want_top), (r, d)
            assert np.array_equal(saved[r][f"bot{d}"], want_bot), (r, d)
        row = PLANE[0] * PLANE[2]
        assert reports[r]["halo"]["crossed"] == {"halo": row, "carry": 0,
                                                 "gather": 0}
        assert reports[r]["halo"]["exchanged"]["halo"] == 7 * row
    assert 2 * sum(rep["halo"]["crossed"]["halo"] for rep in reports) \
        == 4096     # two chroma planes at the seam


def test_exclusive_carry_across_ranks(ranks):
    """Stripe d's carry is the int64 sum of the totals of stripes 0..d-1;
    rank 1 receives rank 0's four totals once each (96 B, int64 on the
    wire), rank 0 receives nothing, and the copies into each stripe's
    device add up as on one process (28 copies of 24 B)."""
    reports, saved = ranks
    for r in (0, 1):
        for d in reports[r]["mine"]:
            want = sum((totals(e) for e in range(d)),
                       np.zeros((1, 3), np.int64))
            got = saved[r][f"carry{d}"]
            assert got.dtype == np.int64 and np.array_equal(got, want)
    assert reports[0]["carry"]["crossed"]["carry"] == 0
    assert reports[1]["carry"]["crossed"]["carry"] == 4 * 3 * 8 <= 384
    assert sum(rep["carry"]["exchanged"]["carry"] for rep in reports) \
        == 28 * 24


def test_gather_rows_across_ranks(ranks):
    """Every rank gathers the whole, the short last stripe included; it
    receives the other rank's rows and nothing more."""
    reports, saved = ranks
    want = np.concatenate([rows(d) for d in range(STRIPES)], axis=1)
    per_rank = [sum(rows(d).nbytes for d in range(4 * r, 4 * r + 4))
                for r in (0, 1)]
    for r in (0, 1):
        assert np.array_equal(saved[r]["whole"], want)
        assert reports[r]["gather"]["crossed"]["gather"] == per_rank[1 - r]
        assert reports[r]["gather"]["exchanged"]["gather"] == want.nbytes


def test_several_messages_each_way_in_one_round(ranks):
    reports, _ = ranks
    for r in (0, 1):
        src = 1 - r
        assert reports[r]["ring"] == [[10 * src + k] * (k + 1)
                                      for k in range(3)]


def test_dryrun_checks_each_ranks_own_shards(ranks):
    reports, _ = ranks
    for rep in reports:
        assert rep["dryrun"]["mesh"] == {"data": 2, "stripe": 4}
        assert {"dp", "sp", "dp x sp", "prefix stream", "bits stream",
                "stripe bits", "dp x sp bits", "lossless stream"} \
            <= set(rep["dryrun"]["checks"])


def test_a_rank_that_raises_fails_the_launch():
    script = ("import sys, time\n"
              "if sys.argv[1] == '1': raise SystemExit(3)\n"
              "time.sleep(60)\n")
    rcs, _texts = launch_ranks(
        lambda r, port: [sys.executable, "-c", script, str(r)], timeout_s=30)
    assert rcs[1] == 3 and rcs[0] != 0      # the waiting rank is stopped


def test_a_mesh_without_a_process_group_is_all_local():
    assert not pdist.initialized() and pdist.current_rank() == 0
    mesh = make_mesh({"data": 2, "stripe": 4}, ["cpu"] * 8)
    assert mesh.owners.shape == (2, 4) and not mesh.owners.any()
    assert mesh.rank == 0 and mesh.processes == 1
    assert all(mesh.is_local(i) for i in np.ndindex(2, 4))
    assert mesh.axis_owners("stripe", "data").shape == (4, 2)
    assert mesh.first == torch.device("cpu")


@pytest.mark.parametrize("exchange", ["halo", "carry", "gather"])
def test_one_process_exchanges_are_unchanged_by_owners(exchange):
    """Without a process group, owners all 0 (this process) take the same
    path as no owners: the same tensors, the same bytes, none crossed."""
    def run(owners):
        mesh_mod.reset_exchanged()
        if exchange == "halo":
            out = [t for pair in mesh_mod.halo_rows(
                [torch.from_numpy(planes(d)) for d in range(STRIPES)],
                owners) for t in pair]
        elif exchange == "carry":
            out = mesh_mod.exclusive_carry(
                [torch.from_numpy(totals(d)) for d in range(STRIPES)],
                owners)
        else:
            out = [mesh_mod.gather_rows(
                [torch.from_numpy(rows(d)) for d in range(STRIPES)],
                torch.device("cpu"), 1, owners)]
        return out, dict(mesh_mod.EXCHANGED), dict(mesh_mod.CROSSED)

    plain, bytes_plain, crossed_plain = run(None)
    owned, bytes_owned, crossed_owned = run(np.zeros(STRIPES, np.int64))
    assert all(torch.equal(a, b) for a, b in zip(plain, owned))
    assert len(plain) == len(owned)
    assert bytes_plain == bytes_owned and bytes_plain[exchange] > 0
    assert crossed_plain == crossed_owned == {"halo": 0, "carry": 0,
                                              "gather": 0}


def test_the_service_refuses_a_mesh_across_processes():
    devices = np.array([torch.device("cpu")] * 2, dtype=object)
    mesh = Mesh(devices, ("data",), np.array([0, 1]), rank=0, processes=2)
    with pytest.raises(NotImplementedError, match="ROADMAP item 16"):
        BatchDecodeService(mesh, device="cpu")

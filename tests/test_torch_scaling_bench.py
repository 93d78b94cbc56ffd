"""The port's mesh sweep (`tools/scaling_bench_torch.py`) on CPU slots: the
rows' structure and the bit-equality of every output, never a time (a CPU
time says nothing of the card)."""

import pytest
import torch

from tools import scaling_bench_torch as sb

IMAGE = sb.REPO / "tests" / "fixtures" / "torch_port" / "small_444.jpg"
KEYS = {"part", "slots", "batch", "ms", "mpix_per_s", "launches_per_image",
        "kernel_launches_per_image", "overhead_t1_over_tn", "equal"}


@pytest.fixture(scope="module")
def rows():
    lines = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # small tensors; the workers share cores
    try:
        out = sb.sweep(IMAGE.read_bytes(), (1, 2), "cpu", batch_per_device=1,
                       log=lines.append)
    finally:
        torch.set_num_threads(threads)
    assert sb.HEADER in lines[0]
    return out


@pytest.mark.parametrize("part,batches", [("dp", [1, 2]),
                                          ("fixed_batch", [2, 2]),
                                          ("stripes", [1, 1])])
def test_rows_at_1_and_2_cpu_slots(rows, part, batches):
    mine = [r for r in rows if r["part"] == part]
    assert [r["slots"] for r in mine] == [1, 2]
    assert [r["batch"] for r in mine] == batches
    for r in mine:
        assert KEYS <= set(r)
        assert r["equal"] is True
        assert r["launches_per_image"] is None       # no card: not measured
        assert r["kernel_launches_per_image"] == {}  # plain versions only
        assert r["ms"] > 0 and r["overhead_t1_over_tn"] > 0
    assert mine[0]["overhead_t1_over_tn"] == 1.0


def test_stripe_sweep_across_two_processes(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # each rank: one thread
    out = sb.run_processes(str(IMAGE), (2,), "cpu", timeout_s=120,
                           log=lambda line: None)
    assert sorted(r["rank"] for r in out) == [0, 1]
    for r in out:
        assert (r["slots"], r["local_slots"], r["processes"]) == (2, 1, 2)
        assert r["equal"] is True and r["ms"] > 0 and r["one_device_ms"] > 0

"""Shared helpers of the benchmark's CPU tests:

    python -m pytest portbench/tests -q

A cell runs here at a small size (`small_run`), through the port's plain
PyTorch kernels; the card's tests take the `cuda` fixture, which skips
where there is no card."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from portbench.harness import registry, runner  # noqa: E402

# One intra-op thread a test process: under pytest-xdist, torch's default
# of a thread a core in every worker starves them all.
torch.set_num_threads(1)

def small_config(name: str) -> dict:
    """Configuration `name` at a small size, odd edges included: each size
    class keeps its grain and takes any size."""
    cfg = registry.config(name)
    cfg.update(width=70, height=46)
    cfg["size_classes"] = [{"scan_bytes": [0, 1 << 30], "noise": c["noise"]}
                           for c in cfg["size_classes"]]
    return cfg


def small_run(name: str, seconds: float = 6.0, seed: int = 2 ** 31 + 5,
              device: str = "cpu", **kw) -> dict:
    """One run of cell `name` at its configuration's small size, with the
    cell's own batch, pool and calls in flight."""
    cell = registry.workload(name)
    return runner.run(cell, seed, seconds, False, torch.device(device),
                      config=small_config(cell["config"]), **kw)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)

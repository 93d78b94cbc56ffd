"""The port's mutation fuzzer (`tools/fuzz_torch.py`) on the CPU.

- Host mode (40 mutants) and guided mode (50 iterations, its curve JSON
  written) in subprocesses: both set JPEG_TPU_DISABLE_NATIVE, which a test
  must not set in-process.
- Device mode in-process on "cpu" (every kernel wrapper on its plain
  version): 30 sources in streams of 6, batch 1 and 4, both interchanges
  and both precisions, against the host oracle.
- A cross-package differential: 20 fixed mutants (fixture and seed), the
  port tool's outcome equal to the JAX package's
  `jpeg_decoder_tpu.Decoder(backend="numpy")`: the same error class name,
  or the same bytes.
- One pinned mutant per outcome class of the device mode (accepted,
  fallback, typed error, lossless), each through every check of a stream.
"""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jpeg_decoder_tpu as ref
from tools import fuzz_torch as fz

REPO = Path(__file__).resolve().parent.parent
TOOL = REPO / "tools" / "fuzz_torch.py"
# Seeds cheap enough for the CPU tests' plain K1 (no 512 x 512 fixture).
CHEAP = ["small_444.jpg", "small_422.jpg", "small_gray.jpg", "small_dri.jpg",
         "small_cmyk_420.jpg", "small_422_progressive.jpg", "quirk.jpg",
         "sof3_p1_8.jpg", "sof3_p6_8_rgb.jpg", "sof3_p7_8.jpg"]


@pytest.fixture
def one_thread():
    """Torch on one thread for the in-process device mode: its tensors are
    small, and the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tool(*args, timeout=120):
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith("JPEG_TPU_")}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, str(TOOL), *map(str, args)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_host_mode_40_mutants(tmp_path):
    res = _tool(40, 5, "--out", tmp_path)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "fuzz complete: 40 mutants, 0 failures" in res.stdout
    assert "PIL leg:" in res.stdout


def test_guided_mode_50_iterations_writes_both_curves(tmp_path):
    res = _tool(50, 5, "--guided", "--lean-seeds", "--out", tmp_path)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    curve = json.loads((tmp_path / "fuzz_guided_curve_lean.json").read_text())
    assert curve["iterations"] == 50 and curve["seeds"] == 1
    assert curve["crashes"] == []
    assert curve["random_curve"][-1] == [50, curve["random_final_lines"]]
    assert curve["guided_curve"][-1] == [50, curve["guided_final_lines"]]
    assert curve["random_final_lines"] > 100


def test_device_mode_30_sources_on_cpu(tmp_path, one_thread):
    res = fz.run_device(30, 3, seeds=CHEAP, out=str(tmp_path), device="cpu",
                        log=lambda line: None)
    assert res["failures"] == 0, list(tmp_path.iterdir())
    assert res["sources"] == 30 and res["device"] == "cpu"
    # 5 streams: every (interchange, precision) pair at batch 1 and 4.
    assert len(fz.PAIRS) == 4 and fz.BATCH == 4
    assert 0 < res["mutants"] < 30
    assert res["accepted"] and res["fallbacks"] and res["lossless"]
    assert res["k1_scans_checked"] >= res["accepted"]
    assert res["decoder_checked"] > 20
    assert sum(res["launches"].values()) == 0    # plain versions on the CPU


def _ref_outcome(data: bytes):
    """tools/fuzz_torch.py::host_outcome on the JAX package's decoder."""
    d = ref.Decoder(data, backend="numpy")
    d.set_max_decoding_buffer_size(fz.CAP)
    try:
        d.read_info()
        info = d.info()
        if info is not None and fz._samples(info) > 16 << 20:
            return "ERR:FormatError(oversize-precheck)"
        return d.decode()
    except ref.JpegError as e:
        return f"ERR:{type(e).__name__}"


DIFFERENTIAL = [(name, seed) for seed, name in enumerate(
    ["small_444.jpg", "small_422.jpg", "small_gray.jpg", "small_dri.jpg",
     "small_cmyk_420.jpg", "small_rgb_444.jpg", "small_422_progressive.jpg",
     "quirk.jpg", "sof3_p1_16.jpg", "sof3_p7_8.jpg"] * 2)]


@pytest.mark.parametrize("name,seed", DIFFERENTIAL,
                         ids=[f"{n}-{s}" for n, s in DIFFERENTIAL])
def test_port_outcome_equals_the_jax_package(name, seed):
    data = fz.seed_corpus([name])[name]
    rng = random.Random(seed)
    mutant = (fz.header_mutant(data, rng) if seed % 3 == 0
              else fz.mutate(data, rng) if seed % 3 == 1
              else fz.entropy_mutant(data, rng))
    assert mutant != data
    got, _ = fz.host_outcome(mutant)
    assert got == _ref_outcome(mutant)


# One mutant per outcome class: (seed, entropy_mutant's rng seed, route,
# the oracle's error).
PINNED = {
    "accepted": ("small_444.jpg", 1, "accepted", None),
    "fallback": ("small_444.jpg", 0, "fallback", None),
    "typed_error": ("small_422_progressive.jpg", 1, "error", "FormatError"),
    "lossless": ("sof3_p6_16.jpg", 1, "lossless", None),
}


@pytest.mark.parametrize("case", sorted(PINNED))
def test_pinned_mutant_per_outcome_class(case, tmp_path, one_thread):
    name, k, route, error = PINNED[case]
    mutant = fz.entropy_mutant(fz.seed_corpus([name])[name],
                               random.Random(k))
    assert fz.route_of(mutant) == route
    assert fz.oracle_of(mutant).error == error
    log = []
    dev = fz.DeviceFuzz("cpu", str(tmp_path), log=log.append)
    for k, (interchange, precision) in enumerate(fz.PAIRS):
        dev.check_stream(k, [mutant], [True], interchange, precision)
    assert dev.stats["failures"] == 0, log
    stat = {"accepted": "accepted", "fallback": "fallbacks",
            "error": "typed_errors", "lossless": "lossless"}[route]
    assert dev.stats[stat] == len(fz.PAIRS)
    assert dev.stats["k1_scans_checked"] == (
        len(fz.PAIRS) if route in ("accepted", "fallback") else 0)

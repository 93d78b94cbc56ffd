"""The port's host axes (`tools/ci_matrix_torch.sh`) against the JAX
package, on the CPU.

Three switches change what the host stage ships to the device: the
pure-Python entropy engine (JPEG_TPU_DISABLE_NATIVE=1), the speculative
prescan split forced onto every segment of at least 4 KiB
(JPEG_TPU_SPEC_PRESCAN=4096) and the span classes
(JPEG_TPU_CLASS_COLLAPSE=0). Tests set no JPEG_TPU_* variable in-process,
so each axis, the default one too, runs in a subprocess of its own whose
environment holds that switch and no other JPEG_TPU_* variable
(`axis_runs`; the four start together). Each stages small_444, tower_420,
`quirk_jpeg(0)` and a 64 x 64 16-bit SOF3 stream through both packages'
`stage_host_bits` and decodes them with `DeviceStreamDecoder(device="cpu")`
(the kernels' plain versions) at fast and exact on both interchanges. Checked, per axis and
input:
- the port's wire equals the JAX package's under the same switch, element
  for element (the delta or anchor wire per scan, `s_max`; the difference
  planes of SOF3; and, from `stage_host`, the prefix interchange's wire),
  and both packages ran the engine the switch selects;
- against the default axis, the port's wire is equal where the JAX
  package's two wires are equal and differs where they differ (the
  Python engine lists the prefix wire's residuals in another order than
  the native one, in both packages); under the forced speculative split
  both packages' anchors stay byte-identical to the default's
  (`tools/ci_matrix.sh:78-79`);
- the pixels, on both interchanges, equal the default axis's: bit for bit
  at exact and in lossless, within 3 at fast.
And the script itself: `bash -n` is clean, its legs are exactly the
counterparts it names, the legs with no counterpart are named in a comment,
the card legs skip without CUDA, and no Python file it runs outside `tests/`
imports `jax` or `jpeg_decoder_tpu`.
"""

import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "tools" / "ci_matrix_torch.sh"
PIXEL_TOL = 3     # the fast tier's contract against the exact decode
AXES = {"default": {},
        "engine-off": {"JPEG_TPU_DISABLE_NATIVE": "1"},
        "spec-4096": {"JPEG_TPU_SPEC_PRESCAN": "4096"},
        "collapse-off": {"JPEG_TPU_CLASS_COLLAPSE": "0"}}
SWITCHED = [a for a in AXES if a != "default"]
INPUTS = ("small_444", "tower_420", "quirk", "sof3")
LEGS = ("native+cpu", "oracle+cpu", "dryrun4", "dryrun8", "multiproc2",
        "entry", "fuzz200", "fuzzdev200", "specprescan", "fuzzdev-spec",
        "collapse-off", "card", "card-oracle")
NOT_PORTED = ("interpret-slow", "gatherasm", "fusedasm", "pack16-off",
              "wire-words-packed", "wire-slots", "benchsmoke")


def _inputs() -> dict:
    from tools.make_torch_fixtures import sof3_jpeg, sof3_samples
    from torch_inputs import fixture, quirk_jpeg

    return {"small_444": fixture("small_444.jpg"),
            "tower_420": fixture("tower_420.jpg"),
            "quirk": quirk_jpeg(0),
            "sof3": sof3_jpeg(sof3_samples(64, 64, 1, 16, 0, seed=0), 6, 0,
                              16)}


def _anchors(scan) -> tuple:
    n = scan.n_items
    return (np.asarray(scan.anchor_bits[:n]).copy(),
            np.asarray(scan.anchor_block[:n + 1]).copy(),
            np.asarray(scan.anchor_slot[:n]).copy())


def _port_wire(st) -> dict:
    """One scan's wire as `_reference_wire` gives the JAX package's."""
    out = {"words": st.words, "dm": st.dm, "s_max": st.s_max}
    if st.ab is not None:
        out.update(ab=st.ab, base=st.base)
    return out


def _prefix_wire(st) -> dict:
    return {"dc": st.dc, "ac": st.ac, "resid_idx": st.resid_idx,
            "resid_vals": st.resid_vals}


def run_axis(out: str) -> None:
    """One axis, in the environment this process was started with: each
    input staged by both packages and decoded by the port on the CPU,
    pickled to `out`."""
    import torch

    torch.set_num_threads(1)
    import jpeg_decoder_tpu_torch as jt
    from jpeg_decoder_tpu.entropy.native import get_native as jax_native
    from jpeg_decoder_tpu.models.stream import stage_host as jax_stage_host
    from jpeg_decoder_tpu.models.stream import \
        stage_host_bits as jax_stage_host_bits
    from jpeg_decoder_tpu_torch.host.entropy.native import get_native
    from jpeg_decoder_tpu_torch.host.staging import stage_host
    from test_torch_host_copy import _reference_wire

    inputs = _inputs()
    record = {"engine": {"port": get_native() is not None,
                         "jax": jax_native() is not None}}
    for name, data in inputs.items():
        port, ref = jt.stage_host_bits(data), jax_stage_host_bits(data)
        if hasattr(port, "diffs"):
            rec = {"port": [{"diffs": port.diffs}],
                   "jax": [{"diffs": ref.diffs}], "port_anchors": [],
                   "jax_anchors": []}
        else:
            rec = {"port": [_port_wire(st) for st in port.scans],
                   "jax": [_reference_wire(scan) for scan, _ in ref.scans],
                   "port_anchors": [_anchors(st.scan) for st in port.scans],
                   "jax_anchors": [_anchors(scan) for scan, _ in ref.scans]}
            # The prefix interchange's wire, P1's input.
            rec["port"].append(_prefix_wire(stage_host(data)))
            rec["jax"].append(_prefix_wire(jax_stage_host(data)))
        record[name] = rec
    for interchange in ("bits", "prefix"):
        for precision in ("fast", "exact"):
            with jt.DeviceStreamDecoder(device="cpu", host_threads=1,
                                        precision=precision,
                                        interchange=interchange) as dec:
                images = dec.decode_stream(list(inputs.values()))
            for name, img in zip(inputs, images):
                record[name][f"{interchange} {precision}"] = img.numpy()
    with open(out, "wb") as f:
        pickle.dump(record, f)


@pytest.fixture(scope="module")
def axis_runs(tmp_path_factory) -> dict:
    """axis -> its subprocess's record (`run_axis`), the four axes run at
    once, each with no JPEG_TPU_* variable but its own."""
    from jpeg_decoder_tpu.entropy.native import get_native as jax_native

    jax_native()    # the JAX package's library built once, before the four
    tmp = tmp_path_factory.mktemp("ci_matrix")
    base = {k: v for k, v in os.environ.items()
            if k != "PYTHONPATH" and not k.startswith("JPEG_TPU_")}
    base.update(OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    code = ("import sys; sys.path[:0] = ['tests', '.']; "
            "import test_torch_ci_matrix as m; m.run_axis(sys.argv[1])")
    procs = {axis: subprocess.Popen(
        [sys.executable, "-c", code, str(tmp / f"{axis}.pkl")], cwd=REPO,
        env={**base, **switch}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for axis, switch in AXES.items()}
    runs = {}
    for axis, proc in procs.items():
        _out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{axis}: {err[-3000:]}"
        with open(tmp / f"{axis}.pkl", "rb") as f:
            runs[axis] = pickle.load(f)
    return runs


def _same_wire(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


@pytest.mark.parametrize("axis", list(AXES))
def test_both_packages_ran_the_engine_the_switch_selects(axis_runs, axis):
    native = axis != "engine-off"
    assert axis_runs[axis]["engine"] == {"port": native, "jax": native}


@pytest.mark.parametrize("name", INPUTS)
@pytest.mark.parametrize("axis", list(AXES))
def test_port_wire_equals_the_jax_package(axis_runs, axis, name):
    rec = axis_runs[axis][name]
    assert len(rec["port"]) == len(rec["jax"]) >= 1
    for got, want in zip(rec["port"], rec["jax"]):
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for got, want in zip(rec["port_anchors"], rec["jax_anchors"]):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", INPUTS)
@pytest.mark.parametrize("axis", SWITCHED)
def test_switched_wire_against_the_default_wire(axis_runs, axis, name):
    """The port's wire moves off the default one exactly where the JAX
    package's does; the split keeps both packages' anchors."""
    rec, default = axis_runs[axis][name], axis_runs["default"][name]
    if axis == "spec-4096":
        for side in ("port", "jax"):
            for got, want in zip(rec[f"{side}_anchors"],
                                 default[f"{side}_anchors"]):
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)
    assert _same_wire(rec["port"], default["port"]) == \
        _same_wire(rec["jax"], default["jax"])


@pytest.mark.parametrize("name", INPUTS)
@pytest.mark.parametrize("axis", SWITCHED)
def test_switched_pixels_equal_the_default(axis_runs, axis, name):
    rec, default = axis_runs[axis][name], axis_runs["default"][name]
    for key in ("bits fast", "bits exact", "prefix fast", "prefix exact"):
        got, want = rec[key], default[key]
        assert got.shape == want.shape and got.dtype == want.dtype
        if key.endswith("exact") or name == "sof3":
            np.testing.assert_array_equal(got, want)
        else:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert int(diff.max()) <= PIXEL_TOL


def test_script_is_valid_bash():
    assert os.access(SCRIPT, os.X_OK)
    res = subprocess.run(["bash", "-n", str(SCRIPT)], capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0 and not res.stderr, res.stderr


def _legs(text: str) -> list:
    legs = []
    for line in text.splitlines():
        m = re.match(r'\s*run "([^"]+)"', line)
        if m:
            legs.append(m.group(1))
    loop = re.search(r'for n in ([\d ]+); do\s+run "dryrun\$n"', text)
    return [leg for leg in legs if leg != "dryrun$n"] + [
        f"dryrun{n}" for n in loop.group(1).split()]


def test_script_runs_exactly_the_legs_and_names_the_rest():
    text = SCRIPT.read_text()
    assert sorted(_legs(text)) == sorted(LEGS)
    comments = " ".join(line for line in text.splitlines()
                        if line.lstrip().startswith("#"))
    for leg in NOT_PORTED:
        assert leg in comments, leg
    assert "no counterpart" in comments
    # Each leg's switch is set by `env` on its own command line.
    for switch in ("JPEG_TPU_DISABLE_NATIVE=1", "JPEG_TPU_SPEC_PRESCAN=4096",
                   "JPEG_TPU_CLASS_COLLAPSE=0"):
        assert re.search(rf"\benv (\w+=\S* )*{switch}\b", text), switch
    assert "export" not in text and "os.environ" not in text
    # The Python it runs inline imports the port only.
    code = [line for line in text.splitlines()
            if not line.lstrip().startswith("#")]
    assert not [line for line in code
                if re.search(r"\b(jax|jaxlib|jpeg_decoder_tpu)\b", line)]


def test_card_legs_skip_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: these legs would run")
    res = subprocess.run(["bash", str(SCRIPT), "card", "card-oracle"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.splitlines() == ["=== [card] SKIP (no CUDA)",
                                       "=== [card-oracle] SKIP (no CUDA)"]


SCRIPT_PYTHON = sorted({p for p in re.findall(r"[\w/]+\.py",
                                              SCRIPT.read_text())
                        if not p.startswith("tests/")
                        and (REPO / p).is_file()})


@pytest.mark.parametrize("path", SCRIPT_PYTHON)
def test_script_python_imports_neither_jax_nor_the_jax_package(path):
    from test_torch_no_jax import _imported_modules

    bad = sorted(m for m in _imported_modules(REPO / path)
                 if m.split(".")[0] in ("jax", "jaxlib", "jpeg_decoder_tpu"))
    assert not bad, f"{path} imports {bad}"

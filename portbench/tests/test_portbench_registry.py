"""Cells, configurations and metrics are found by name, agree with
`BENCHMARK.json`, and nothing the benchmark loads is JAX or the JAX
package (compared by whole top-level module name: the port's name begins
with the JAX package's)."""

import ast
import json
import subprocess
import sys

import pytest

from portbench.harness import registry, runner

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PB = ROOT / "portbench"


def test_benchmark_json_names_files_that_exist():
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    for cfg in BENCH["configs"]:
        assert (ROOT / cfg["file"]).exists()
        assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
        assert registry.config(cfg["name"])["reduced"] == cfg["reduced"]
        assert registry.config(cfg["name"])["source"] == cfg["source"]
    for w in BENCH["workloads"]:
        cell = registry.workload(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) \
            == (w["config"], w["traffic"], w["chips"], w["why"])
        cfg = registry.config(cell["config"])
        assert registry.generator(cfg["generator"]).generate
        assert registry.reference(cfg["reference"]).expected


def test_every_listed_metric_has_a_reader_that_agrees():
    readers = registry.metric_readers()
    listed = {m["name"]: m for m in BENCH["per_layer"]}
    assert set(listed) == set(readers)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert e2e == set(runner.END_TO_END_UNITS)
    cells = {w["name"] for w in BENCH["workloads"]}
    for name, m in listed.items():
        mod = readers[name]
        assert (m["layer"], m["source"], m["unit"], m["moves"]) == \
            (mod.LAYER, mod.SOURCE, mod.UNIT, mod.MOVES), name
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
    for cell in cells:
        assert registry.listed_per_layer(cell) == {
            name for name, m in listed.items()
            if cell in m.get("workloads", [cell])}


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        registry.workload("no-such.cell")
    with pytest.raises(ValueError):
        registry.workload("../BENCHMARK")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(runner.FORBIDDEN), path
    for path in (PB / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert runner.PORT not in tops, path
        assert runner.PORT not in path.read_text().replace(
            "jpeg_decoder_tpu_torch/host", ""), path


def test_a_run_loads_no_jax():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})\n"
        "import conftest\n"
        "from portbench.harness import runner\n"
        "res = conftest.small_run('photo-large.exact-b8')\n"
        "print(json.dumps({'correct': res['correct'],"
        " 'found': runner.forbidden_modules(),"
        " 'port': 'jpeg_decoder_tpu_torch' in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"correct": True, "found": [], "port": True}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jpeg_decoder_tpu_torch_x", object())
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jpeg_decoder_tpu.sub", object())
    assert runner.forbidden_modules() == ["jpeg_decoder_tpu"]


def test_the_command_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "photo-large.exact-b8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    if out.returncode == 0:
        pytest.skip("a card is present: the run is the chip's to check")
    assert out.stdout.strip() == "" and "CUDA" in out.stderr


def test_a_run_fails_without_the_program(tmp_path):
    """A directory of BENCHMARK.json and the benchmark's files alone: the
    command prints nothing on standard output and exits with an error."""
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(PB), str(tmp_path / "portbench")],
                   check=True)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "photo-large.exact-b8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "jpeg_decoder_tpu_torch is not in this checkout" in out.stderr

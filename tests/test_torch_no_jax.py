"""The PyTorch port must run without JAX and without the JAX package:
- a fresh interpreter imports `jpeg_decoder_tpu_torch`, stages and decodes
  on the CPU in the interleaved and the planar-pallas layouts, and through
  every other path of the one-image decoder (exact precision, progressive
  and quirk streams through transcode, the three-table-pair anchor wire,
  the prefix interchange and lossless), in batches (`batch_size=3`) and
  on a mesh of CPU slots (groups over "data", `decode_striped`), with
  the process group's module (`parallel/dist.py`) and the multi-process
  harness (`tools/multiproc_mesh_torch.py`) imported, and through the
  port's tools (the fuzzer's device mode, the mesh sweep, the jpg -> png
  CLI),
  and must end with no `jax`,
  `jaxlib`, `triton` or `jpeg_decoder_tpu` module loaded and no CUDA
  library built or loaded: the port stages through its own copy of the
  host code, `jpeg_decoder_tpu_torch.host`;
- no source of the port, nor `chip_smoke.py` or the tools it imports,
  imports `jax` or `jpeg_decoder_tpu` (read with `ast`, so a function-level
  import counts too);
- `DeviceStreamDecoder()`, `Decoder()` and `BatchDecodeService()` target
  the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
import torch
torch.set_num_threads(1)   # small images; the test workers share the cores
import jpeg_decoder_tpu_torch as jt
from jpeg_decoder_tpu_torch import _build
assert "jax" not in sys.modules, "import loaded jax"
data = open("tests/fixtures/torch_port/small_dri.jpg", "rb").read()
with jt.DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
    img = dec.decode_stream([data])[0]
assert tuple(img.shape) == (190, 250, 3), img.shape
# The planar-pallas layout reads pallas_tail_mode from the JAX package's
# pallas_kernels module, which must not load JAX either.
with jt.DeviceStreamDecoder(device="cpu", host_threads=1,
                            layout="planar-pallas") as dec:
    planar = dec.decode_stream([data])[0]
assert dec._effective_layout(dec.stage(data).geometry) == "planar-pallas"
assert (planar == img.permute(2, 0, 1)).all()

sys.path.insert(0, "tests")
from torch_inputs import quirk_jpeg, three_table_pairs
from tools.make_torch_fixtures import sof3_jpeg, sof3_samples
prog = open("tests/fixtures/torch_port/small_422_progressive.jpg", "rb").read()
inputs = [data, prog, quirk_jpeg(2), three_table_pairs(data)]
kinds = [[s.wire for s in jt.stage_host_bits(d).scans] for d in inputs]
assert kinds == [["delta"], ["delta"], ["delta"], ["anchor"]], kinds
for interchange in ("bits", "prefix"):
    for precision in ("fast", "exact"):
        with jt.DeviceStreamDecoder(device="cpu", host_threads=1,
                                    precision=precision,
                                    interchange=interchange) as dec:
            out = dec.decode_stream(inputs)
        assert [tuple(o.shape) for o in out] == [
            (190, 250, 3), (131, 197, 3), (24, 40), (190, 250, 3)]
lossless = [sof3_jpeg(sof3_samples(9, 11, 1, 16, 0, seed=1), 6, 0, 16),
            sof3_jpeg(sof3_samples(9, 11, 3, 8, 1, seed=2), 4, 1, 8)]
with jt.DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
    out = dec.decode_stream(lossless)
assert [(tuple(o.shape), str(o.dtype)) for o in out] == [
    ((9, 11), "torch.uint16"), ((9, 11, 3), "torch.uint8")], out
# Batches: a bits group (merged wire, one sweep), a lossless group and a
# prefix group.
for interchange in ("bits", "prefix"):
    with jt.DeviceStreamDecoder(device="cpu", host_threads=1,
                                interchange=interchange) as dec:
        out = dec.decode_stream([data, data, data] + lossless[:1] * 2,
                                batch_size=3)
    assert [tuple(o.shape) for o in out] == [(190, 250, 3)] * 3 + [(9, 11)] * 2
    assert all((o == out[0]).all() for o in out[1:3])
# The front end, the service and the stage timer.
timer = jt.StageTimer()
pixels = jt.Decoder(data, precision="fast", device="cpu",
                    timer=timer).decode_array()
assert pixels.shape == (190, 250, 3) and dict(timer.counts)["d2h"] == 1
assert jt.Decoder(lossless[0], device="cpu").decode_array().shape == (9, 11)
assert [a.shape for a in jt.decode_many([data, prog], device="cpu")] == [
    (190, 250, 3), (131, 197, 3)]
with jt.DeviceStreamDecoder(device="cpu", host_threads=1,
                            timer=timer) as dec:
    dec.decode_stream([data, data], batch_size=2)
assert timer.counts["host_stage"] == 2
# The mesh: groups over "data", one image's stripes over "stripe".
from jpeg_decoder_tpu_torch.parallel import make_mesh
mesh = make_mesh({"data": 2, "stripe": 2}, ["cpu"] * 4)
with jt.DeviceStreamDecoder(mesh=mesh, host_threads=1) as dec:
    out = dec.decode_stream([data] * 3, batch_size=3)
    assert all((o == img).all() for o in out)
    assert tuple(dec.decode_striped(data).shape) == (190, 250, 3)
# The process group's module and the multi-process harness: outside a
# group the mesh is one process and a transfer round is empty.
from jpeg_decoder_tpu_torch.parallel import dist
import tools.multiproc_mesh_torch as harness
assert (dist.current_rank(), dist.world_size()) == (0, 1)
assert dist.Transport().run() == [] and harness.N_PROCS == 2
# The port's tools: the fuzzer's device mode, the sweep and the CLI.
import importlib.util
import tempfile
import tools.fuzz_torch as fuzz
import tools.scaling_bench_torch as sweep
res = fuzz.run_device(6, 0, seeds=["small_gray.jpg", "sof3_p7_8.jpg"],
                      device="cpu", log=lambda line: None)
assert res["failures"] == 0 and res["sources"] == 6, res
rows = sweep.sweep(open("tests/fixtures/torch_port/small_gray.jpg",
                        "rb").read(), (1,), "cpu", 1, log=lambda line: None)
assert all(r["equal"] for r in rows), rows
spec = importlib.util.spec_from_file_location("decode_torch",
                                              "examples/decode_torch.py")
cli = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cli)
with tempfile.TemporaryDirectory() as tmp:
    assert cli.main(["tests/fixtures/torch_port/small_gray.jpg",
                     tmp + "/g.png", "--device", "cpu"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton",
                                    "jpeg_decoder_tpu"))
assert not bad, bad
assert _build._lib is None, "a CPU decode loaded the CUDA library"
assert sum(jt.LAUNCHES.values()) == 0
print("ok")
"""


def test_port_decodes_without_importing_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


# The port and what `chip_smoke.py` runs on the card.
PORT_SOURCES = (
    sorted((REPO / "jpeg_decoder_tpu_torch").rglob("*.py"))
    + [REPO / "chip_smoke.py", REPO / "tools" / "torch_port_profile.py",
       REPO / "tools" / "experiments" / "fused_recon_probe_torch.py",
       REPO / "tools" / "experiments" / "k1_step_probe.py",
       REPO / "tools" / "experiments" / "k4_phase_probe.py",
       REPO / "tools" / "experiments" / "l1_step_probe.py",
       REPO / "tools" / "experiments" / "h2d_probe.py",
       REPO / "tools" / "experiments" / "stream_ab.py",
       REPO / "tools" / "experiments" / "path_ab.py",
       REPO / "tools" / "experiments" / "a1_breakdown.py",
       REPO / "tools" / "multiproc_mesh_torch.py",
       REPO / "tools" / "fuzz_torch.py",
       REPO / "tools" / "scaling_bench_torch.py",
       REPO / "examples" / "decode_torch.py"])


def _imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_SOURCES])
def test_port_sources_import_neither_jax_nor_the_jax_package(path):
    bad = sorted(m for m in _imported_modules(path)
                 if m.split(".")[0] in ("jax", "jaxlib", "jpeg_decoder_tpu"))
    assert not bad, f"{path.name} imports {bad}"


def test_device_stream_decoder_targets_cuda_by_default():
    import inspect

    import torch

    from jpeg_decoder_tpu_torch import DeviceStreamDecoder

    default = inspect.signature(DeviceStreamDecoder).parameters["device"]
    assert default.default == "cuda"
    if torch.cuda.is_available():
        with DeviceStreamDecoder(host_threads=1) as dec:
            assert dec.device.type == "cuda"
    else:   # asking for the card where there is none raises
        with pytest.raises(RuntimeError, match="cuda"):
            DeviceStreamDecoder()
    with DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
        assert dec.device.type == "cpu"


def test_decoder_and_service_target_cuda_by_default():
    """The front end and the service default to backend "torch" on "cuda"
    and raise without a card; "auto" never turns the card into the CPU."""
    import inspect

    import torch

    import jpeg_decoder_tpu_torch as jt

    data = (REPO / "tests/fixtures/torch_port/small_gray.jpg").read_bytes()
    for cls in (jt.Decoder, jt.BatchDecodeService):
        params = inspect.signature(cls).parameters
        assert params["device"].default == "cuda"
        assert params["backend"].default == "torch"
    if torch.cuda.is_available():
        assert jt.Decoder(data).device.type == "cuda"
        return
    for backend in ("torch", "auto"):
        with pytest.raises(RuntimeError, match="cuda"):
            jt.Decoder(data, backend=backend)
    with pytest.raises(RuntimeError, match="cuda"):
        jt.BatchDecodeService()
    assert jt.Decoder(data, backend="numpy").decode_array().shape \
        == (117, 171)

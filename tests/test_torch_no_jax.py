"""The PyTorch port must run without JAX: a fresh interpreter imports
`jpeg_decoder_tpu_torch`, stages and decodes on the CPU in the interleaved
and the planar-pallas layouts, and through every other path of the
one-image decoder (exact precision, progressive and quirk streams through
transcode, the three-table-pair anchor wire, the prefix interchange and
lossless), and must end with no `jax` (and no `triton`) module loaded and
no CUDA library built or loaded. This guards against staging through the
JAX package's `stage_host_bits`, whose `_attach_pallas` imports JAX, and
against the function-level `import jax` all over its models/stream.py."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton"))
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

"""The port's jpg -> png CLI (`examples/decode_torch.py`) on the CPU: every
fixture and an 8-bit and a 16-bit SOF3 stream through `--backend numpy`
and `--backend torch --device cpu`, each PNG read back through zlib equal
to `Decoder(backend="numpy")`'s array after the same CMYK and L16
conversions; and one CMYK fixture equal to the JAX package's decode through
examples/decode.py's `cmyk_to_rgb`."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jpeg_decoder_tpu as ref
import jpeg_decoder_tpu_torch as jt
from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "torch_port"


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cli = _load("decode_torch_example", REPO / "examples" / "decode_torch.py")
SOF3 = {"sof3_8bit.jpg": (8, 1), "sof3_16bit.jpg": (16, 6)}
CASES = sorted(p.name for p in FIXTURES.glob("*.jpg")) + sorted(SOF3)


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the images are small and the test workers
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _source(name: str, tmp_path: Path) -> Path:
    if name not in SOF3:
        return FIXTURES / name
    precision, predictor = SOF3[name]
    path = tmp_path / name
    path.write_bytes(sof3_jpeg(sof3_samples(40, 56, 1, precision, 0, seed=9),
                               predictor, 0, precision))
    return path


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("name", CASES)
def test_png_equals_the_host_decode(name, backend, tmp_path, capsys):
    src = _source(name, tmp_path)
    png = tmp_path / "out.png"
    assert cli.main([str(src), str(png), "--backend", backend,
                     "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    d = jt.Decoder(src.read_bytes(), backend="numpy")
    want = cli.viewable(d.decode_array(), d.info().pixel_format)
    got = cli.read_png(png.read_bytes())
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    info = d.info()
    assert f"{info.width}x{info.height} {info.pixel_format.value}" in printed
    assert "exif: False" in printed and f"wrote {png}" in printed


def test_cmyk_png_equals_the_reference_example(tmp_path):
    src = FIXTURES / "small_cmyk_420.jpg"
    png = tmp_path / "cmyk.png"
    assert cli.main([str(src), str(png), "--device", "cpu", "--precision",
                     "exact"]) == 0
    example = _load("decode_example", REPO / "examples" / "decode.py")
    px = ref.Decoder(src.read_bytes()).decode_array()
    assert np.array_equal(cli.read_png(png.read_bytes()),
                          example.cmyk_to_rgb(px))
    assert np.array_equal(cli.cmyk_to_rgb(px), example.cmyk_to_rgb(px))


def test_streaming_and_scale_flags(tmp_path, capsys):
    src = FIXTURES / "small_444.jpg"
    png = tmp_path / "scaled.png"
    assert cli.main([str(src), str(png), "--streaming", "--scale", "60x40",
                     "--backend", "numpy"]) == 0
    d = jt.Decoder(src.read_bytes(), backend="numpy")
    assert f"scaled to: {d.scale(60, 40)}" in capsys.readouterr().out
    assert np.array_equal(cli.read_png(png.read_bytes()), d.decode_array())


def test_png_writer_refuses_what_it_cannot_write():
    with pytest.raises(ValueError):
        cli.png_bytes(np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError):
        cli.png_bytes(np.zeros((4, 4, 4), np.uint8))

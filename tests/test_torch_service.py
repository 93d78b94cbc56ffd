"""The port's batch service, `jpeg_decoder_tpu_torch.BatchDecodeService`
(and `decode_many`), against the JAX package's `BatchDecodeService(
backend="numpy")` and `backend="jax"` on CPU JAX, on the committed
fixtures and a synthesized stream of mixed geometries. Tolerance:
bit-equal (the staging builds each geometry at precision "exact", so every
reconstruction is integer math). The service on a mesh is held against
the reference's in tests/test_torch_mesh.py.
"""

import numpy as np
import pytest

import jpeg_decoder_tpu_torch as jt
from jpeg_decoder_tpu.models.service import \
    BatchDecodeService as RefService

from torch_inputs import SMALL_FIXTURES, fixture, synth_jpeg


@pytest.fixture(scope="module")
def sources() -> list:
    """Every small fixture, a repeat (one geometry twice) and two synthesized
    4:2:0 sizes."""
    return [fixture(n) for n in SMALL_FIXTURES] + [
        fixture("small_444.jpg"), synth_jpeg(72, 40, seed=41),
        synth_jpeg(40, 72, seed=42)]


@pytest.fixture(scope="module")
def reference(sources) -> list:
    return RefService(host_threads=2, backend="numpy").decode_all(sources)


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert isinstance(a, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_service_equal_to_the_reference(sources, reference, backend):
    _equal(jt.BatchDecodeService(host_threads=2, backend=backend,
                                 device="cpu").decode_all(sources),
           reference)


def test_service_equal_to_the_jax_backend(sources):
    _equal(jt.BatchDecodeService(host_threads=2, device="cpu")
           .decode_all(sources[:4]),
           RefService(host_threads=2, backend="jax").decode_all(sources[:4]))


def test_service_scaled(sources):
    picked = [fixture("small_422.jpg"), fixture("small_gray.jpg")]
    _equal(jt.BatchDecodeService(host_threads=2, device="cpu")
           .decode_all(picked, scale_to=(40, 30)),
           RefService(host_threads=2, backend="numpy")
           .decode_all(picked, scale_to=(40, 30)))


def test_decode_many(sources, reference):
    _equal(jt.decode_many(sources, host_threads=3, device="cpu"), reference)


def test_service_matches_the_decoder(sources):
    """Each image equals the port's own Decoder on the device path."""
    got = jt.BatchDecodeService(host_threads=2, device="cpu") \
        .decode_all(sources[:3])
    for data, img in zip(sources[:3], got):
        np.testing.assert_array_equal(
            img.reshape(-1),
            np.frombuffer(jt.Decoder(data, device="cpu").decode(), np.uint8))


def test_mesh_and_unknown_backend_raise():
    """A mesh with a device it does not hold raises (the mesh places the
    work; the mesh path itself: tests/test_torch_mesh.py), as does an
    unknown backend."""
    from jpeg_decoder_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"data": 2}, ["cpu"] * 2)
    with pytest.raises(ValueError, match="with a mesh"):
        jt.BatchDecodeService(mesh=mesh, device="cuda:1")
    with pytest.raises(ValueError, match="with a mesh"):
        jt.decode_many([], mesh=mesh, device="cuda:1")
    with pytest.raises(ValueError, match="backend"):
        jt.BatchDecodeService(backend="jax", device="cpu")

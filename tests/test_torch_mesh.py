"""The port's mesh and its store-level parallel axes
(`jpeg_decoder_tpu_torch.parallel`: `mesh`, `batch`, `stripes`,
`dryrun`) against the JAX package's `jpeg_decoder_tpu.parallel`, on CPU
meshes: the port's on `make_mesh(..., devices=["cpu"] * n)`, the JAX
package's on the conftest's 8-device virtual CPU mesh.

- `make_mesh`: axes, shape and device order as `jax.sharding.Mesh` has
  them; too few devices raise; without CUDA and without `devices` it
  raises (no CPU default).
- The exchanges: the halo rows and zeros at the ends, the exclusive carry,
  the gather, and the bytes `EXCHANGED` counts; a halo between two slots
  of one device is a copy.
- `decode_batch_sharded`, `decode_striped` and `decode_striped_batch`:
  bit-equal to the reference's at precision "exact"; the batch at "fast"
  within 1 of the reference's fp32 tier.
- `BatchDecodeService(mesh=...)` equal to the reference's service with a
  mesh; `dryrun_multichip` on 8, 4 and 3 CPU slots.
Inputs: the host copy's stores of the committed fixtures and of seeded
PIL images (`torch_inputs`).
"""

import numpy as np
import pytest
import torch

import jpeg_decoder_tpu_torch as jt
from jpeg_decoder_tpu.models.service import \
    BatchDecodeService as RefService
from jpeg_decoder_tpu.ops.pipeline import \
    ImageGeometry as RefGeometry
from jpeg_decoder_tpu.parallel import (decode_batch_sharded as ref_batch,
                                       decode_striped as ref_striped,
                                       decode_striped_batch as
                                       ref_striped_batch)
from jpeg_decoder_tpu_torch.host.decoder import Decoder as HostDecoder
from jpeg_decoder_tpu_torch.host.ops.pipeline import geometry_from_frame
from jpeg_decoder_tpu_torch.parallel import (decode_batch_sharded,
                                             decode_striped,
                                             decode_striped_batch, make_mesh)
from jpeg_decoder_tpu_torch.parallel import mesh as mesh_mod
from jpeg_decoder_tpu_torch.parallel.dryrun import dryrun_multichip

from test_torch_batch import _one_torch_thread  # noqa: F401
from torch_inputs import fixture, stripe_jpeg


def _jax_mesh(shape: dict):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(list(shape.values())))
    return Mesh(np.array(jax.devices("cpu")[:n]).reshape(
        tuple(shape.values())), tuple(shape))


def _stores(data: bytes, precision: str = "exact"):
    """(geometry, stores, qts, mcu_rows, golden bytes) by the host copy, as
    the reference's tests/test_parallel.py takes them."""
    d = HostDecoder(data, backend="numpy")
    golden = d.decode()
    n = len(d.frame.components)
    stores = [d._pending_render[i][0].reshape(-1, 64) for i in range(n)]
    qts = [d._pending_render[i][1] for i in range(n)]
    transform = None if n == 1 else d._determine_color_transform()
    geometry = geometry_from_frame(d.frame, transform, precision=precision)
    return geometry, stores, qts, d.frame.mcu_size.height, golden


def _ref_geometry(geometry):
    """The same geometry as the reference's class (its jit cache key)."""
    from jpeg_decoder_tpu.ops.color import ColorTransform
    from jpeg_decoder_tpu.ops.pipeline import ComponentGeometry

    return RefGeometry(
        components=tuple(ComponentGeometry(**vars(c))
                         for c in geometry.components),
        out_width=geometry.out_width, out_height=geometry.out_height,
        transform=(None if geometry.transform is None
                   else ColorTransform(geometry.transform.value)),
        precision=geometry.precision)


# The upsampler modes the fixtures give the stripes: h2v2 (the halo),
# h2v1, h1v1, gray and CMYK; odd sizes leave padding stripes.
STRIPED = {
    "tower_420": lambda: fixture("tower_420.jpg"),
    "small_422": lambda: fixture("small_422.jpg"),
    "small_444": lambda: fixture("small_444.jpg"),
    "small_gray": lambda: fixture("small_gray.jpg"),
    "cmyk_420": lambda: fixture("small_cmyk_420.jpg"),
    "420_odd": lambda: stripe_jpeg(100, 90, "RGB", 108, subsampling=2),
}


def test_make_mesh_axes_and_order():
    mesh = make_mesh({"data": 2, "stripe": 4}, ["cpu"] * 8)
    assert mesh.axis_names == ("data", "stripe")
    assert list(mesh.shape.items()) == [("data", 2), ("stripe", 4)]
    assert mesh.devices.shape == (2, 4) and mesh.first == torch.device("cpu")
    assert mesh.axis_devices("stripe", "data").shape == (4, 2)
    assert mesh.axis_devices("data").shape == (2,)
    assert mesh.params(mesh.first) is mesh.params(torch.device("cpu"))
    assert make_mesh({"data": 3}, ["cpu"] * 8).devices.shape == (3,)
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh({"data": 2, "stripe": 4}, ["cpu"] * 7)
    with pytest.raises(ValueError, match="no axis"):
        mesh.axis_devices("model")


def test_make_mesh_without_cuda_and_devices_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh({"data": 1})
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh({"data": 1}, ["cuda:0"])


def test_exchanges():
    mesh_mod.reset_exchanged()
    planes = [torch.arange(12, dtype=torch.uint8).reshape(1, 3, 4) + 16 * d
              for d in range(3)]
    halos = mesh_mod.halo_rows(planes)
    assert not halos[0][0].any() and not halos[2][1].any()
    assert torch.equal(halos[1][0], planes[0][:, -1:])
    assert torch.equal(halos[1][1], planes[2][:, :1])
    assert (halos[1][0].untyped_storage().data_ptr()     # a copy
            != planes[0].untyped_storage().data_ptr())
    assert mesh_mod.EXCHANGED["halo"] == 4 * 4
    totals = [torch.tensor([d + 1, -d], dtype=torch.int64) for d in range(4)]
    carries = mesh_mod.exclusive_carry(totals)
    assert [c.tolist() for c in carries] == [[0, 0], [1, 0], [3, -1],
                                            [6, -3]]
    assert mesh_mod.EXCHANGED["carry"] == 6 * 16
    rows = mesh_mod.gather_rows(planes, torch.device("cpu"), dim=1)
    assert torch.equal(rows, torch.cat(planes, 1))
    assert mesh_mod.EXCHANGED["gather"] == 36


@pytest.mark.parametrize("name", ["small_444.jpg", "tower_420.jpg",
                                  "small_gray.jpg"])
def test_batch_sharded_equals_the_reference(name):
    geometry, stores, qts, _rows, golden = _stores(fixture(name))
    batched = [np.broadcast_to(s, (4,) + s.shape).copy() for s in stores]
    got = decode_batch_sharded(geometry, batched, qts,
                               make_mesh({"data": 4}, ["cpu"] * 4))
    want = ref_batch(_ref_geometry(geometry), batched, qts,
                     _jax_mesh({"data": 4}))
    assert got.shape == want.shape and np.array_equal(got, want)
    assert all(img.tobytes() == golden for img in got)


def test_batch_sharded_fast_within_one_and_uneven():
    """At "fast" (K2's plain version on the shards) within 1 of the
    reference's fp32 tier; 3 images over 2 devices (2 + 1) equal to the
    one-device reconstruction of each."""
    geometry, stores, qts, _rows, _golden = _stores(fixture("tower_420.jpg"),
                                                    "fast")
    batched = [np.broadcast_to(s, (4,) + s.shape).copy() for s in stores]
    got = decode_batch_sharded(geometry, batched, qts,
                               make_mesh({"data": 2}, ["cpu"] * 2))
    want = ref_batch(_ref_geometry(geometry), batched, qts,
                     _jax_mesh({"data": 2}))
    assert np.abs(got.astype(int) - np.asarray(want).astype(int)).max() <= 1
    uneven = decode_batch_sharded(geometry, [b[:3] for b in batched], qts,
                                  make_mesh({"data": 2}, ["cpu"] * 2))
    assert np.array_equal(uneven, got[:3])


@pytest.mark.parametrize("name,n", [(name, 4) for name in STRIPED]
                         + [("tower_420", 8), ("420_odd", 8)])
def test_striped_equals_the_reference(name, n):
    data = STRIPED[name]()
    geometry, stores, qts, mcu_rows, golden = _stores(data)
    if mcu_rows < n:
        n = mcu_rows
    got = decode_striped(geometry, stores, qts,
                         make_mesh({"stripe": n}, ["cpu"] * n), mcu_rows)
    assert got.tobytes() == golden
    want = ref_striped(_ref_geometry(geometry), stores, qts,
                       _jax_mesh({"stripe": n}), mcu_rows)
    assert np.array_equal(got, np.asarray(want))


def test_striped_batch_equals_the_reference():
    geometry, stores, qts, mcu_rows, golden = _stores(
        fixture("tower_420.jpg"))
    batched = [np.broadcast_to(s, (4,) + s.shape).copy() for s in stores]
    got = decode_striped_batch(geometry, batched, qts,
                               make_mesh({"data": 2, "stripe": 4},
                                         ["cpu"] * 8), mcu_rows)
    want = ref_striped_batch(_ref_geometry(geometry), batched, qts,
                             _jax_mesh({"data": 2, "stripe": 4}), mcu_rows)
    assert np.array_equal(got, np.asarray(want))
    assert all(img.tobytes() == golden for img in got)


def test_service_with_a_mesh_equals_the_reference():
    """Buckets of 2 and 4 same-table images split over "data" (2), a
    single image alone; equal to the reference's service on a JAX mesh."""
    sources = ([fixture("small_444.jpg")] * 2 + [fixture("small_422.jpg")]
               * 4 + [fixture("small_gray.jpg")])
    got = jt.BatchDecodeService(make_mesh({"data": 2}, ["cpu"] * 2),
                                host_threads=2).decode_all(sources)
    want = RefService(_jax_mesh({"data": 2}), host_threads=2).decode_all(
        sources)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, np.asarray(b))
    odd = jt.decode_many(sources[2:5], make_mesh({"data": 2}, ["cpu"] * 2))
    assert all(np.array_equal(a, b) for a, b in zip(odd, got[2:5]))


@pytest.mark.parametrize("n", [8, 4, 3])
def test_dryrun_multichip(n):
    ran = dryrun_multichip(n, ["cpu"] * n)
    assert ran["mesh"] == {"data": 2 if n % 2 == 0 else 1,
                           "stripe": n // (2 if n % 2 == 0 else 1)}
    assert {"dp", "sp", "bits stream", "stripe bits",
            "lossless stream"} <= set(ran["checks"])
    if n % 2 == 0:
        assert {"dp x sp", "dp x sp bits"} <= set(ran["checks"])

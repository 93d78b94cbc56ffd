"""`DeviceStreamDecoder(mesh=...)` of the port on CPU meshes
(`make_mesh(..., devices=["cpu"] * n)`): batched groups split over the
"data" axis and `decode_striped` over a "stripe" axis.

- Bits, prefix and lossless groups on a mesh are bit-equal to the port's
  meshless decode of each image, in every precision and interchange, and
  at "exact" (and lossless) to the JAX package's `DeviceStreamDecoder(
  mesh=...)` on the conftest's 8-device virtual CPU mesh.
- The shards: `_batch_bucket(n)` rounded up to the data size, contiguous
  rows per device, no decode for the padding, one K1 sweep per shard; the
  mesh's bits key merges no plans; a `None` slot flushes every group.
- `decode_striped`: bit-equal to the host decode (the exact IDCT), to the
  JAX decoder's, and its fallbacks (no stripe axis, an image that
  declines) equal to `decode_one`.
Inputs: committed fixtures and seeded PIL and SOF3 streams
(`torch_inputs`, `tools/make_torch_fixtures.py`).
"""

import functools

import numpy as np
import pytest
import torch

import jpeg_decoder_tpu_torch as jt
import jpeg_decoder_tpu_torch.models.stream as port_stream
from jpeg_decoder_tpu.models.stream import \
    DeviceStreamDecoder as JaxStreamDecoder
from jpeg_decoder_tpu_torch.host.decoder import Decoder as HostDecoder
from jpeg_decoder_tpu_torch.parallel import make_mesh

from test_torch_batch import (_assert_bit_equal,  # noqa: F401
                              _one_torch_thread, _sof3)
from torch_inputs import fixture, stripe_jpeg, synth_jpeg

BAD = b"\xff\xd8 definitely not a jpeg"
MESHES = {"data4": {"data": 4}, "data3": {"data": 3},
          "data2xstripe2": {"data": 2, "stripe": 2}}


def _mesh(shape: dict):
    return make_mesh(shape, ["cpu"] * int(np.prod(list(shape.values()))))


def _jax_mesh(shape: dict):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(list(shape.values())))
    return Mesh(np.array(jax.devices("cpu")[:n]).reshape(
        tuple(shape.values())), tuple(shape))


def _stream() -> list:
    """Five images of one key (a group over every shard), three grayscale
    ones, one 4:2:2 (a group of one) and the restart-interval fixture."""
    return ([synth_jpeg(64, 48, seed=1)] * 5
            + [synth_jpeg(40, 24, seed=5, mode="L")] * 3
            + [synth_jpeg(48, 32, seed=6, subsampling=1),
               fixture("small_dri.jpg")])


def _decode(stream, batch_size=1, mesh=None, **kw) -> list:
    place = {"device": "cpu"} if mesh is None else {"mesh": mesh}
    with jt.DeviceStreamDecoder(host_threads=2, **place, **kw) as dec:
        return dec.decode_stream(stream, batch_size=batch_size)


@functools.lru_cache(maxsize=None)
def _meshless(precision: str, interchange: str) -> tuple:
    return tuple(_decode(_stream(), 1, precision=precision,
                         interchange=interchange))


@pytest.mark.parametrize("interchange", ["bits", "prefix"])
@pytest.mark.parametrize("precision", ["fast", "exact"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_groups_bit_equal_to_the_meshless_decode(mesh, precision,
                                                      interchange):
    kw = {"precision": precision, "interchange": interchange}
    _assert_bit_equal(_decode(_stream(), 8, _mesh(MESHES[mesh]), **kw),
                      _meshless(precision, interchange))


def test_mesh_groups_planar_pallas():
    stream = _stream()[:5]
    _assert_bit_equal(_decode(stream, 8, _mesh({"data": 4}),
                              layout="planar-pallas"),
                      _decode(stream, 1, layout="planar-pallas"))


@pytest.mark.parametrize("predictor", [1, 6])
def test_lossless_groups_on_a_mesh(predictor):
    stream = ([_sof3(predictor, 3, 16, 0)] * 5
              + [_sof3(predictor, 1, 8, 1)] * 2)
    got = _decode(stream, 8, _mesh({"data": 4}))
    _assert_bit_equal(got, _decode(stream, 1))
    want = JaxStreamDecoder(host_threads=2, mesh=_jax_mesh({"data": 4})) \
        .decode_stream(stream, batch_size=8)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("interchange", ["bits", "prefix"])
def test_mesh_groups_equal_the_jax_mesh_at_exact(interchange):
    stream = _stream()
    got = _decode(stream, 8, _mesh({"data": 4}), precision="exact",
                  interchange=interchange)
    want = JaxStreamDecoder(host_threads=2, precision="exact",
                            interchange=interchange,
                            mesh=_jax_mesh({"data": 4})).decode_stream(
        stream, batch_size=8)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g.numpy(),
                                                     np.asarray(w))


@pytest.mark.parametrize("n,data,sizes", [(5, 4, [2, 2, 1]),
                                          (3, 3, [2, 1]),
                                          (16, 4, [4, 4, 4, 4]),
                                          (1, 2, [1])])
def test_shards_take_contiguous_rows(monkeypatch, n, data, sizes):
    """The reference's split: rows per device = _batch_bucket(n) rounded up
    to a multiple of the data size, over the data size; the padding rows
    hold no image and are not decoded; one K1 sweep per shard; each
    image's tensor on its shard's device."""
    calls, sweeps = [], []
    decode_group = port_stream.DeviceStreamDecoder._decode_group
    k1 = port_stream.decode_chunks

    def spy_group(self, kind, group, dev=None):
        calls.append((len(group), dev))
        return decode_group(self, kind, group, dev)

    monkeypatch.setattr(port_stream.DeviceStreamDecoder, "_decode_group",
                        spy_group)
    monkeypatch.setattr(port_stream, "decode_chunks",
                        lambda *a: sweeps.append(1) or k1(*a))
    stream = [synth_jpeg(64, 48, seed=1)] * n
    mesh = _mesh({"data": data})
    out = _decode(stream, 16, mesh)
    assert [c[0] for c in calls] == sizes
    devs = list(mesh.axis_devices("data"))
    assert [c[1] for c in calls] == devs[:len(sizes)]
    assert len(sweeps) == len(sizes)
    assert [o.device for o in out] == [d for d, s in zip(devs, sizes)
                                       for _ in range(s)]


def test_mesh_key_merges_no_plans(monkeypatch):
    """Small images of two plans from one encoder share the hetero key (one
    sweep without a mesh); on a mesh each plan is a group of its own, as
    the reference keys them (`stream.py:1684-1685`)."""
    a, b = synth_jpeg(64, 48, seed=1), synth_jpeg(48, 64, seed=3)
    groups = []
    real = port_stream.DeviceStreamDecoder._decode_group_mesh

    def spy(self, kind, group):
        groups.append(len(group))
        return real(self, kind, group)

    monkeypatch.setattr(port_stream.DeviceStreamDecoder,
                        "_decode_group_mesh", spy)
    stream = [a, a, b, b, a]
    _assert_bit_equal(_decode(stream, 8, _mesh({"data": 2})),
                      _decode(stream, 1))
    assert groups == [2, 2, 1]


@pytest.mark.parametrize("interchange", ["bits", "prefix"])
def test_on_error_none_flushes_groups_on_a_mesh(interchange):
    good = synth_jpeg(64, 48, seed=1)
    stream = [good, good, BAD, good, good, good]
    with jt.DeviceStreamDecoder(mesh=_mesh({"data": 2}), host_threads=2,
                                interchange=interchange) as dec:
        out = dec.decode_stream(stream, batch_size=4, on_error="none")
    want = _decode([good], 1, interchange=interchange)[0]
    assert [o is None for o in out] == [False, False, True, False, False,
                                        False]
    assert all(torch.equal(o, want) for o in out if o is not None)


def test_decode_striped_and_its_fallbacks():
    """Eligible: bit-equal to the host decode and the JAX decoder's stripes
    (the exact IDCT at any precision). A 16x16 image (fewer MCU rows than
    stripes), a mesh with no stripe axis and no mesh: `decode_one`."""
    data = stripe_jpeg(200, 240, "RGB", 3, subsampling=2)
    gold = HostDecoder(data, backend="numpy").decode_array()
    with jt.DeviceStreamDecoder(mesh=_mesh({"stripe": 4}),
                                host_threads=1) as dec:
        got = dec.decode_striped(data, engine="xla")
        assert got.device == dec.device
        assert np.array_equal(got.numpy(), gold)
        small = stripe_jpeg(16, 16, "RGB", 4, subsampling=2)
        assert torch.equal(dec.decode_striped(small),
                           _decode([small], 1)[0])
        with pytest.raises(ValueError, match="one engine"):
            dec.decode_striped(data, engine="pallas")
    want = JaxStreamDecoder(host_threads=1, interchange="bits",
                            mesh=_jax_mesh({"stripe": 4})).decode_striped(
        data, engine="xla")
    assert np.array_equal(got.numpy(), np.asarray(want))
    for place in ({"mesh": _mesh({"data": 2})}, {"device": "cpu"}):
        with jt.DeviceStreamDecoder(host_threads=1, **place) as dec:
            assert torch.equal(dec.decode_striped(data),
                               _decode([data], 1)[0])


def test_the_mesh_places_the_decoder():
    """With a mesh the decoder runs on the mesh's first device: `device`
    stays at its default or names that device."""
    with pytest.raises(ValueError, match="with a mesh"):
        jt.DeviceStreamDecoder(mesh=_mesh({"data": 2}), device="cuda:1")
    for place in ({}, {"device": "cpu"}):
        with jt.DeviceStreamDecoder(mesh=_mesh({"data": 2}), host_threads=1,
                                    **place) as dec:
            assert dec.device == torch.device("cpu")
            assert dec.params is dec.mesh.params(dec.device)

"""The compiled dispatch of lossless (SOF3) images (`models/graphs.py`: one
graph per `lossless_key`) against the JAX package's
`_compiled_lossless_pipeline`, on the CPU.

The JAX package compiles the lossless pipeline once per `(ncomp,
predictor, pt, precision, restart_all, out_w, out_h, batch)`
(`stream.py:766-815`; batch None for one image, `_batch_bucket(n)` for a
group, which it pads with its last image), and `jax.jit` traces the
planes' [C, H, W]. The JAX keys here come from the JAX package's own
`stage_host_bits` on the same bytes.

- Keys: over SOF3 streams across predictor, point transform, precision,
  size, component count and the `restart_all` quirk, one image and groups
  of 3 and 4 of each, two share `lossless_key` exactly when they share
  the JAX key.
- Samples: predictors 1-7 at point transforms 0 and 2 (Ra at pt 2 stays
  on the host in both packages), one image at a time and as a group of 3
  (a graph of 4 images, one pad slot), bit-equal to the JAX package's
  `DeviceStreamDecoder` at batch 1 and 4.
- Pads: a group of 3 through a graph of 4, its pad planes the last
  image's, 3 images returned, the graph's body run eagerly equal to its
  output.
- Refill: two images of one key landed before either runs; each lands its
  planes again and decodes its own image.
On the CPU every call goes through its graph's arena (on a card a key's
first call runs off any graph).
"""

import functools

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu.models.stream import \
    DeviceStreamDecoder as JaxStreamDecoder
from jpeg_decoder_tpu.models.stream import _batch_bucket as jax_batch_bucket
from jpeg_decoder_tpu.models.stream import \
    stage_host_bits as jax_stage_host_bits
from jpeg_decoder_tpu_torch import DeviceStreamDecoder, stage_host_bits
from jpeg_decoder_tpu_torch.models import graphs
from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

from test_lossless_restart_order import _build_lossless_jpeg

# (h, w, ncomp, precision, pt, predictor, seed) of each keyed stream.
STREAMS = {
    "base": (12, 16, 1, 16, 0, 1, 0),
    "base again": (12, 16, 1, 16, 0, 1, 1),
    "predictor 6": (12, 16, 1, 16, 0, 6, 0),
    "pt 2": (12, 16, 1, 16, 2, 6, 0),
    "12 bits": (12, 16, 1, 12, 0, 1, 0),
    "8 bits": (12, 16, 1, 8, 0, 1, 0),
    "taller": (16, 12, 1, 16, 0, 1, 0),
    "three": (12, 16, 3, 16, 0, 1, 0),
    "three again": (12, 16, 3, 16, 0, 1, 2),
}
RESTARTS = ("restart_all", "no restart")
NAMES = sorted(STREAMS) + list(RESTARTS)
PAIRS = [(a, b) for i, a in enumerate(NAMES) for b in NAMES[i:]]


@pytest.fixture(autouse=True)
def one_thread():
    """Small images; the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sof3(h, w, ncomp, precision, pt, predictor, seed) -> bytes:
    return sof3_jpeg(sof3_samples(h, w, ncomp, precision, pt, seed=seed),
                     predictor, pt, precision)


@functools.lru_cache(maxsize=None)
def _stream(name: str) -> bytes:
    if name in RESTARTS:
        diffs = np.random.default_rng(5).integers(-7, 8, (6, 7))
        return _build_lossless_jpeg(diffs, dri=1 if name == "restart_all"
                                    else 0, predictor=2)
    return _sof3(*STREAMS[name])


@functools.lru_cache(maxsize=None)
def _staged(name: str) -> tuple:
    """(the JAX package's staging, the port's) of one stream."""
    data = _stream(name)
    return jax_stage_host_bits(data), stage_host_bits(data)


def jax_key(st, count) -> tuple:
    """`_compiled_lossless_pipeline`'s arguments (batch None for one
    image, else the count bucket) with the planes' shape it traces."""
    return (st.diffs.shape[0], st.predictor, st.point_transform,
            st.precision, st.restart_all, st.out_width, st.out_height,
            None if count is None else jax_batch_bucket(count),
            st.diffs.shape)


@pytest.mark.parametrize("a,b", PAIRS, ids=[f"{a}~{b}" for a, b in PAIRS])
def test_keys_shared_exactly_when_the_jax_keys_are(a, b):
    """One image of each, and a group of 3 of a beside groups of 4 and 5
    of b (one count bucket, then another)."""
    (ja, pa), (jb, pb) = _staged(a), _staged(b)
    for ca, cb in ((None, None), (3, 4), (3, 5)):
        port_a = graphs.lossless_key(pa if ca is None else [pa] * ca)
        port_b = graphs.lossless_key(pb if cb is None else [pb] * cb)
        same_jax = jax_key(ja, ca) == jax_key(jb, cb)
        assert (port_a == port_b) == same_jax, (ca, cb, port_a, port_b)


def test_the_streams_share_and_split_keys():
    """The streams reach both answers: two contents of one configuration
    share a key, each other configuration has its own, and the restart
    quirk splits one."""
    keys = {name: graphs.lossless_key(_staged(name)[1]) for name in NAMES}
    assert keys["base"] == keys["base again"]
    assert keys["three"] == keys["three again"]
    assert keys["restart_all"] != keys["no restart"]
    assert _staged("restart_all")[1].restart_all
    assert len(set(keys.values())) == len(NAMES) - 2


CASES = [(p, pt) for p in range(1, 8) for pt in (0, 2) if (p, pt) != (1, 2)]


@pytest.mark.parametrize("predictor,pt", CASES,
                         ids=[f"p{p}-pt{pt}" for p, pt in CASES])
def test_samples_through_the_arenas_against_jax(predictor, pt):
    """Three streams of one configuration (three components at pt 0, one
    at pt 2), one at a time (one graph) and as a group of 3 (a graph of
    4), bit-equal to the JAX package at batch 1 and 4 and to the samples
    shifted by the point transform."""
    ncomp, precision = (3, 12) if pt == 0 else (1, 16)
    samples = [sof3_samples(10, 14, ncomp, precision, pt, seed=s)
               for s in range(3)]
    blobs = [sof3_jpeg(s, predictor, pt, precision) for s in samples]
    with DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
        ones = dec.decode_stream(blobs)
        group = dec.decode_stream(blobs, batch_size=4)
        counts = sorted((k[-1] or 1) for k in dec._graphs._graphs)
    assert counts == [1, 4] and len(group) == 3
    jax = JaxStreamDecoder(host_threads=1)
    for got, want in ((ones, jax.decode_stream(blobs)),
                      (group, jax.decode_stream(blobs, batch_size=4))):
        for img, ref, s in zip(got, want, samples):
            np.testing.assert_array_equal(img.to(torch.int32).numpy(),
                                          np.asarray(ref).astype(np.int32))
            np.testing.assert_array_equal(
                img.to(torch.int32).numpy(), s.astype(np.int32) << pt)


def test_a_group_of_three_pads_to_four():
    """A group of 3 through a graph of 4: the pad planes the last image's,
    3 images returned, each equal to its one-image decode and to the
    graph's body run eagerly on the same inputs."""
    blobs = [_sof3(12, 16, 3, 16, 0, 6, seed) for seed in range(3)]
    with DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
        ones = dec.decode_stream(blobs)
        group = [dec.stage(b) for b in blobs]
        fill = dec._group_wires("lossless", group)
        got = dec._run_group("lossless", group, fill)
        eager = dec._run_group_eager("lossless", group, fill)
    (diffs,) = fill.graph.inputs.wires[0]
    assert fill.graph.shape.images == 4 and fill.count == 3
    assert tuple(diffs.shape) == (4, 3, 12, 16)
    assert torch.equal(diffs[3], diffs[2])
    assert len(got) == 3
    for img, one, body in zip(got, ones, eager):
        assert torch.equal(img, one) and torch.equal(img, body)


def test_a_refilled_arena_lands_its_planes_again(monkeypatch):
    """Two images of one key landed before either runs: each lands its
    planes again before it runs and decodes its own image."""
    landed = []
    real = graphs.put_into

    def spy(dst, items):
        landed.append(len(items))
        return real(dst, items)

    monkeypatch.setattr(graphs, "put_into", spy)
    blobs = [_stream("base"), _stream("base again")]
    with DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
        want = dec.decode_stream(blobs)
        staged = [dec.stage(b) for b in blobs]
        fills = [dec._to_device(st) for st in staged]
        assert fills[0].graph is fills[1].graph
        got = [dec._run_device(st, f) for st, f in zip(staged, fills)]
        assert dec._graphs.stats()["graphs"] == 1
    assert landed == [1] * 6
    assert not torch.equal(want[0], want[1])
    assert all(torch.equal(g, w) for g, w in zip(got, want))

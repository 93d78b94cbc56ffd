"""The compiled dispatch of the prefix interchange (`models/graphs.py`: one
graph per `prefix_key`) against the JAX package's `_compiled_prefix_pipeline`
and `_compiled_prefix_pipeline_batched`, on the CPU.

The JAX package compiles a prefix image once per `(geometry, resid_bucket,
layout)` (`stream.py:1319-1333`: the length of the residual lists that its
`stage_host` buckets) and a group once per `(geometry, _bucket(longest
list), _batch_bucket(n), layout)` (`:1948-1995`), the group padded to its
count bucket with its last image. The JAX keys here come from the JAX
package's own `stage_host` on the same bytes.

- Keys: over fixture pairs (tower_420 with tower_420_q92 and with the
  optimised-table `optimized/tower_420_opt.jpg`, that fixture with itself,
  the mixed sizes, the small fixtures, `q100/q100_420.jpg`), one image and
  groups of 3 and 4 of each, two share `prefix_key` exactly when they share
  the JAX key.
- Pixels: three images of one geometry through the arenas, each by
  `decode_one` (one graph) and as `decode_stream(batch_size=4)`'s group
  of 3 (one graph of 4 images, one pad slot), equal to each other, in
  every layout at both precisions, against the JAX package's
  `DeviceStreamDecoder(interchange="prefix")` at batch 4: bit-equal at
  exact, within 3 at fast (planar-pallas runs the fp32 IDCT at either
  precision, as the JAX package's does).
- Pads and the sink: a group of 3 with hand-made residuals (negative,
  duplicate, out-of-range) through a graph of 4: its pad row the last
  image's, every residual index in its own row's stores or at the sink
  past the bucket's, the pixels bit-equal to the JAX package's
  `_decode_group` on the same staging.
- Refill: two images of one key landed before either runs; each lands its
  inputs again and decodes its own image.
On the CPU every call goes through its graph's arena (on a card a key's
first call runs off any graph).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu.models.stream import \
    DeviceStreamDecoder as JaxStreamDecoder
from jpeg_decoder_tpu.models.stream import _batch_bucket as jax_batch_bucket
from jpeg_decoder_tpu.models.stream import _bucket as jax_bucket
from jpeg_decoder_tpu.models.stream import stage_host as jax_stage_host
from jpeg_decoder_tpu_torch import DeviceStreamDecoder
from jpeg_decoder_tpu_torch.host.staging import _bucket, stage_host
from jpeg_decoder_tpu_torch.models import graphs

from test_torch_prefix_rebuild import hand_made_residuals
from torch_inputs import SMALL_FIXTURES, fixture, synth_jpeg

OPT = "optimized/tower_420_opt.jpg"
Q100 = "q100/q100_420.jpg"
MIXED = ("mixed_500x375.jpg", "mixed_375x500.jpg", "mixed_500x333.jpg",
         "mixed_333x500.jpg", "mixed_448x448.jpg", "mixed_320x240.jpg")
PAIRS = ([("tower_420.jpg", "tower_420_q92.jpg"), ("tower_420.jpg", OPT),
          (OPT, OPT), ("tower_420_q92.jpg", OPT), (Q100, Q100),
          (Q100, "tower_420.jpg")]
         + [(a, b) for i, a in enumerate(MIXED) for b in MIXED[i + 1:]]
         + [(a, b) for i, a in enumerate(SMALL_FIXTURES)
            for b in SMALL_FIXTURES[i + 1:]])
FAST_TOL = 3


@pytest.fixture(autouse=True)
def one_thread():
    """Small images; the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _staged(name: str, precision: str) -> tuple:
    """(the JAX package's staging, the port's) of one fixture."""
    data = fixture(name)
    return (jax_stage_host(data, precision=precision),
            stage_host(data, precision=precision))


def jax_key(group: list, layout: str, single: bool) -> tuple:
    """What the JAX package compiles the prefix pipeline on: one image's
    `(geometry, len(resid_idx), layout)`, or a group's `(geometry,
    _bucket(longest), _batch_bucket(n), layout)`."""
    first = group[0]
    if single:
        return (first.geometry, len(first.resid_idx), layout)
    return (first.geometry,
            jax_bucket(max(len(st.resid_idx) for st in group)),
            jax_batch_bucket(len(group)), layout)


def _keys(names: list, precision: str, single: bool) -> tuple:
    jax_group = [_staged(n, precision)[0] for n in names]
    port_group = [_staged(n, precision)[1] for n in names]
    return (graphs.prefix_key(port_group[0] if single else port_group,
                              precision, "interleaved"),
            jax_key(jax_group, "interleaved", single))


@pytest.mark.parametrize("a,b", PAIRS, ids=[f"{a}~{b}" for a, b in PAIRS])
def test_keys_shared_exactly_when_the_jax_keys_are(a, b):
    """One image of each; a group of 3 of a beside one of 4 of b (one count
    bucket) and beside a group of 5 of b (another); a group of a then b
    beside b then a where they share a geometry. Both precisions."""
    cases = [([a], [b], True), ([a] * 3, [b] * 4, False),
             ([a] * 3, [b] * 5, False)]
    if _staged(a, "fast")[1].geometry == _staged(b, "fast")[1].geometry:
        cases.append(([a, b], [b, a], False))
    for precision in ("fast", "exact"):
        for ga, gb, single in cases:
            port_a, jax_a = _keys(ga, precision, single)
            port_b, jax_b = _keys(gb, precision, single)
            assert (port_a == port_b) == (jax_a == jax_b), \
                (precision, ga, gb, port_a[2:], port_b[2:])


def test_the_pairs_share_and_split_keys():
    """The pairs reach both answers: tower_420, tower_420_q92 and the
    optimised fixture share a geometry and split on the residual bucket
    (three keys, where the bits path gives tower_420 and the optimised
    fixture one); a group of the three shares the key of 4 q92; mixed
    sizes of one bucket share none; more keys than geometries."""
    key = functools.partial(graphs.prefix_key, precision="fast",
                            layout="interleaved")
    tower, q92, opt = (_staged(n, "fast")[1]
                       for n in ("tower_420.jpg", "tower_420_q92.jpg", OPT))
    assert tower.geometry == q92.geometry == opt.geometry
    assert len({key(tower), key(q92), key(opt)}) == 3
    assert key([tower, q92, opt]) == key([q92] * 4) != key(q92)
    names = ["tower_420.jpg", "tower_420_q92.jpg", OPT, Q100, *MIXED,
             *SMALL_FIXTURES]
    keys = {key(_staged(n, "fast")[1]) for n in names}
    geometries = {_staged(n, "fast")[1].geometry for n in names}
    assert len(geometries) < len(keys) <= len(names)


def _diff(img: torch.Tensor, ref) -> int:
    ref = np.asarray(ref)
    assert tuple(img.shape) == ref.shape
    return int(np.abs(img.numpy().astype(np.int32)
                      - ref.astype(np.int32)).max())


@functools.lru_cache(maxsize=None)
def _three() -> list:
    return [synth_jpeg(64, 48, seed=s, quality=q)
            for s, q in ((3, 75), (3, 60), (1, 50))]


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("layout", ["interleaved", "planar",
                                    "planar-pallas"])
def test_pixels_through_the_arenas_against_jax(layout, precision):
    """Three images of one geometry through `decode_one` (one graph) and
    as a group of 3 (a graph of 4 images, one pad slot): each group image
    equal to its own `decode_one`, and against the JAX package's group of
    3 (padded to 4)."""
    blobs = _three()
    with DeviceStreamDecoder(device="cpu", host_threads=1, layout=layout,
                             precision=precision,
                             interchange="prefix") as dec:
        staged = [dec.stage(b) for b in blobs]
        ones = [dec.decode_one(st) for st in staged]
        group = dec.decode_stream(blobs, batch_size=4)
        keys = sorted((k[-1] or 1) for k in dec._graphs._graphs)
    assert keys == [1, 4] and len(group) == 3
    assert all(torch.equal(g, o) for g, o in zip(group, ones))
    want = JaxStreamDecoder(host_threads=1, layout=layout,
                            precision=precision, interchange="prefix"
                            ).decode_stream(blobs, batch_size=4)
    exact = precision == "exact" and layout != "planar-pallas"
    for img, ref in zip(group, want):
        assert _diff(img, ref) <= (0 if exact else FAST_TOL)


def test_pads_and_the_sink_against_jax():
    """q100 (residuals in zigzag slots 16-63) and two images of its
    geometry with hand-made residuals, as one group of 3 through a graph
    of 4: the pad row the last image's, the indices in their own rows or
    at the sink, bit-equal to the JAX package's `_decode_group` (its pad
    the last image) on the same staging, each image equal to its own
    `decode_one`, and the graph's body run eagerly equal to its output."""
    pairs = [_staged(Q100, "exact")]
    for seed in (1, 2):
        jst, pst = _staged(Q100, "exact")
        ri, rv = hand_made_residuals(pst, seed)
        pairs.append((dataclasses.replace(jst, resid_idx=ri, resid_vals=rv),
                      dataclasses.replace(pst, resid_idx=ri, resid_vals=rv)))
    group = [p for _j, p in pairs]
    want = JaxStreamDecoder(host_threads=1, precision="exact",
                            interchange="prefix")._decode_group(
        [j for j, _p in pairs])
    with DeviceStreamDecoder(device="cpu", host_threads=1, precision="exact",
                             interchange="prefix") as dec:
        fill = dec._group_wires("prefix", group)
        got = dec._run_group("prefix", group, fill)
        eager = dec._run_group_eager("prefix", group, fill)
        ones = [dec.decode_one(st) for st in group]
    graph = fill.graph
    total = group[0].total_coeffs
    dc, ac, ri, rv = graph.inputs.wires[0]
    assert graph.shape.images == 4 and fill.count == 3 and len(got) == 3
    assert ri.shape[1] == _bucket(max(len(st.resid_idx) for st in group))
    assert torch.equal(dc[3], dc[2]) and torch.equal(ac[3], ac[2])
    assert torch.equal(rv[3], rv[2])
    rows = torch.arange(4)[:, None]
    own = (ri >= rows * total) & (ri < (rows + 1) * total)
    assert bool((own | (ri == 4 * total)).all())
    assert torch.equal(ri[3][own[3]] - total, ri[2][own[2]])
    for img, ref, one, body in zip(got, want, ones, eager):
        assert _diff(img, ref) == 0
        assert torch.equal(img, one) and torch.equal(img, body)


def test_a_refilled_arena_lands_its_inputs_again(monkeypatch):
    """Two images of one key landed before either runs: the second's
    inputs overwrite the arena, so the first lands its own again before
    it runs, and then the second its own; each landing lands the whole
    arena (four wire arrays and one int32 table per component at
    exact)."""
    landed = []
    real = graphs.put_into

    def spy(dst, items):
        landed.append(len(items))
        return real(dst, items)

    monkeypatch.setattr(graphs, "put_into", spy)
    blobs = _three()[:2]
    with DeviceStreamDecoder(device="cpu", host_threads=1, precision="exact",
                             interchange="prefix") as dec:
        want = [dec.decode_one(dec.stage(b)) for b in blobs]
        staged = [dec.stage(b) for b in blobs]
        fills = [dec._to_device(st) for st in staged]
        assert fills[0].graph is fills[1].graph
        got = [dec._run_device(st, f) for st, f in zip(staged, fills)]
        assert dec._graphs.stats()["graphs"] == 1
    assert landed == [7] * 6
    assert all(torch.equal(g, w) for g, w in zip(got, want))

"""The compiled dispatch of mixed-size bits groups (`models/graphs.py`: a
sweep graph per `sweep_key`, a part graph per `part_key`) against the JAX
package's `_decode_group_bits_hetero`, on the CPU.

The JAX package decodes a group of several (plan, geometry) parts with one
`_compiled_bits_sweep` (keyed on the merged wire's bucketed class shapes,
n_tab, the mapped MCU pattern and a bucketed block count, and traced on
the merged arrays' shapes) and one `_compiled_nat_reconstruct` per part,
keyed on `(plan, count_bucket, geometry, layout)`, its offset into the
sweep's coefficients a runtime scalar. The JAX keys here come from the
JAX package's own staging, `pack_delta` and `merge_image_packs_delta` on
the same bytes (its Pallas path is off on the CPU), as
`tests/test_torch_graph_key.py` computes the one-image key.

- Keys: over compositions of the six mixed fixtures (orders, subsets,
  repeats, a plan counted 3 so that its bucket is 4, and one counted 4),
  two compositions share the port's sweep key exactly when they share the
  JAX sweep's, and two parts share the port's part key exactly when they
  share `_compiled_nat_reconstruct`'s.
- Pixels: the mixed group of 8 and a second composition that reuses its
  sweep key through the graphs' arenas, in every layout, against the JAX
  package's `DeviceStreamDecoder.decode_stream(batch_size=8)` on the same
  bytes: bit-equal at exact, within 3 at fast (the reference's contract;
  planar-pallas runs the fp32 IDCT at either precision, as the reference's
  does). Planar outputs are the interleaved ones permuted.
- The anchor wire (the fixtures re-signalled with three table pairs):
  a hetero group through its own sweep key, bit-equal to the host decode.
- Offsets: one part key decoded at two offsets in two compositions.
- Pads: a part of 3 images (count bucket 4) returns 3 images, each equal
  to its batch-1 decode.
- Refill: two groups landed before either runs; each lands its inputs
  again before it runs.
On the CPU every half of a group goes through its graph's arena and runs
its body eagerly (on a card a key's first call runs off any graph).
"""

import functools

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu import Decoder
from jpeg_decoder_tpu.entropy.pallas_decode import \
    merge_image_packs_delta as jax_merge_delta
from jpeg_decoder_tpu.entropy.pallas_decode import pack_delta as jax_pack_delta
from jpeg_decoder_tpu.models.stream import \
    DeviceStreamDecoder as JaxStreamDecoder
from jpeg_decoder_tpu.models.stream import _batch_bucket as jax_batch_bucket
from jpeg_decoder_tpu.models.stream import _bucket as jax_bucket
from jpeg_decoder_tpu.models.stream import \
    stage_host_bits as jax_stage_host_bits
from jpeg_decoder_tpu_torch import DeviceStreamDecoder
from jpeg_decoder_tpu_torch.models import graphs
from jpeg_decoder_tpu_torch.models.stream import GroupHalves

from torch_inputs import fixture, three_table_pairs

MIXED = ("mixed_500x375.jpg", "mixed_375x500.jpg", "mixed_500x333.jpg",
         "mixed_333x500.jpg", "mixed_448x448.jpg", "mixed_320x240.jpg")
# Compositions of the mixed fixtures, by index into MIXED.
COMPOSITIONS = {
    "six": (0, 1, 2, 3, 4, 5),
    "mixed cell": (0, 1, 2, 3, 4, 5, 0, 1),
    "reversed": (5, 4, 3, 2, 1, 0, 4, 3),
    "rotated": (1, 2, 3, 4, 5, 0, 1, 2),
    "pairs": (0, 0, 1, 1, 2, 2, 3, 3),
    "a plan thrice": (0, 0, 0, 1, 2),
    "a plan four times": (1, 0, 0, 0, 0, 2),
    "thrice again": (2, 0, 1, 0, 0),
    "three and three": (2, 2, 2, 5, 5, 5, 4, 4),
    "two": (0, 1),
    "two swapped": (1, 0),
    "subset": (3, 4, 5),
}
FAST_TOL = 3


@pytest.fixture(autouse=True)
def one_thread():
    """Small images; the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_staged(i: int, precision: str):
    return jax_stage_host_bits(fixture(MIXED[i]), None, precision)


def jax_keys(comp: tuple, precision: str, layout: str) -> tuple:
    """(sweep key, part keys in part order) of the JAX package's hetero
    dispatch (`stream.py:1776-1853`) for the images `comp`: the arguments
    of `_compiled_bits_sweep` with the merged arrays' shapes, and
    `_compiled_nat_reconstruct`'s `(plan, count_bucket, geometry,
    layout)` per part."""
    sts = [_jax_staged(i, precision) for i in comp]
    parts: dict = {}
    for k, st in enumerate(sts):
        parts.setdefault((st.scans[0][0].plan, st.geometry), []).append(k)
    order = [k for members in parts.values() for k in members]
    merged = jax_merge_delta([jax_pack_delta(sts[k].scans[0][0])
                              for k in order],
                             [sts[k].scans[0][0].plan.n_blocks
                              for k in order])
    assert merged is not None
    combined, shapes = merged
    scan0 = sts[0].scans[0][0]
    padded = sum(jax_batch_bucket(len(m)) * plan.n_blocks
                 for (plan, _g), m in parts.items())
    sweep = (tuple(s[:3] for s in shapes), len(scan0.tab_maxcode),
             tuple(scan0.comp_to_upair[c] for c in scan0.plan.pattern),
             jax_bucket(padded, floor=4096), "delta",
             tuple(a.shape for a in combined))
    return sweep, [(plan, jax_batch_bucket(len(m)), geometry, layout)
                   for (plan, geometry), m in parts.items()]


def port_halves(dec, comp: tuple, blobs=None) -> GroupHalves:
    blobs = [fixture(n) for n in MIXED] if blobs is None else blobs
    halves = dec._group_wires("bits", [dec.stage(blobs[i]) for i in comp])
    assert isinstance(halves, GroupHalves)
    return halves


def port_keys(comp: tuple, precision: str, layout: str) -> tuple:
    with DeviceStreamDecoder(device="cpu", host_threads=1,
                             precision=precision, layout=layout) as dec:
        halves = port_halves(dec, comp)
    return halves.sweep.graph.key, [f.graph.key for f in halves.recons]


@functools.lru_cache(maxsize=None)
def _keys(name: str, precision: str) -> tuple:
    comp = COMPOSITIONS[name]
    return (port_keys(comp, precision, "interleaved"),
            jax_keys(comp, precision, "interleaved"))


NAMES = sorted(COMPOSITIONS)
PAIRS = [(a, b) for i, a in enumerate(NAMES) for b in NAMES[i:]]


@pytest.mark.parametrize("a,b", PAIRS, ids=[f"{a}~{b}" for a, b in PAIRS])
def test_keys_shared_exactly_when_the_jax_keys_are(a, b):
    for precision in ("fast", "exact"):
        (port_a, jax_a), (port_b, jax_b) = _keys(a, precision), \
            _keys(b, precision)
        assert (port_a[0] == port_b[0]) == (jax_a[0] == jax_b[0]), precision
        assert len(port_a[1]) == len(jax_a[1])
        for pa, ja in zip(port_a[1], jax_a[1]):
            for pb, jb in zip(port_b[1], jax_b[1]):
                assert (pa == pb) == (ja == jb), (precision, pa, pb)


def test_the_compositions_share_and_split_keys():
    """The compositions reach both answers: some share a sweep key and
    some do not; a part key recurs across compositions; the plan counted
    3 takes count bucket 4."""
    sweeps = [_keys(n, "fast")[0][0] for n in NAMES]
    assert 1 < len(set(sweeps)) < len(sweeps)
    parts = [k for n in NAMES for k in _keys(n, "fast")[0][1]]
    assert len(set(parts)) < len(parts)
    assert 4 in {k[4] for k in _keys("a plan thrice", "fast")[0][1]}


@functools.lru_cache(maxsize=None)
def _jax_images(precision: str) -> dict:
    """Each mixed fixture's image from the JAX package's
    `decode_stream(batch_size=8)` over the mixed cell's bytes."""
    comp = COMPOSITIONS["mixed cell"]
    out = JaxStreamDecoder(host_threads=2, interchange="bits",
                           precision=precision).decode_stream(
        [fixture(MIXED[i]) for i in comp], batch_size=8)
    return {i: np.asarray(img) for i, img in zip(comp, out)}


def _diff(img: torch.Tensor, ref: np.ndarray) -> int:
    assert tuple(img.shape) == ref.shape
    return int(np.abs(img.numpy().astype(np.int32)
                      - ref.astype(np.int32)).max())


@pytest.mark.parametrize("layout,precision", [
    ("interleaved", "exact"), ("interleaved", "fast"), ("planar", "exact"),
    ("planar-pallas", "fast")])
def test_pixels_against_jax_through_the_arenas(layout, precision):
    """The mixed group of 8, then the reversed composition (the same sweep
    key, parts at other offsets and counts), through the arenas: every
    image within the reference's contract of the JAX package's, and each
    equal to its own batch-1 decode."""
    blobs = [fixture(n) for n in MIXED]
    comps = (COMPOSITIONS["mixed cell"], COMPOSITIONS["reversed"])
    with DeviceStreamDecoder(device="cpu", host_threads=2, layout=layout,
                             precision=precision) as dec:
        single = dec.decode_stream(blobs)
        got = [dec.decode_stream([blobs[i] for i in comp], batch_size=8)
               for comp in comps]
        kinds = sorted(k[0] for k in dec._graphs._graphs)
    assert kinds.count("sweep") == 1
    ref = _jax_images("exact" if precision == "exact" else "fast")
    exact = precision == "exact" and layout != "planar-pallas"
    for comp, imgs in zip(comps, got):
        for i, img in zip(comp, imgs):
            assert torch.equal(img, single[i]), MIXED[i]
            want = ref[i] if layout == "interleaved" \
                else np.transpose(ref[i], (2, 0, 1))
            assert _diff(img, want) <= (0 if exact else FAST_TOL), MIXED[i]


def test_the_anchor_wire_through_its_sweep():
    """The mixed fixtures re-signalled with three table pairs (the anchor
    wire): one hetero group of 8 and a second composition, each image
    bit-equal to the host's exact decode."""
    blobs = [three_table_pairs(fixture(n)) for n in MIXED]
    comps = (COMPOSITIONS["mixed cell"], COMPOSITIONS["six"])
    with DeviceStreamDecoder(device="cpu", host_threads=2,
                             precision="exact") as dec:
        halves = port_halves(dec, comps[0], blobs)
        assert halves.sweep.graph.key[:2] == ("sweep", "anchor")
        got = [dec.decode_stream([blobs[i] for i in comp], batch_size=8)
               for comp in comps]
    for comp, imgs in zip(comps, got):
        for i, img in zip(comp, imgs):
            np.testing.assert_array_equal(
                img.numpy(), Decoder(blobs[i], backend="numpy",
                                     precision="exact").decode_array())


def test_one_part_key_at_two_offsets():
    """mixed_375x500's part (count 1) at offset 0 in one composition and
    behind two other images' rows in another: one graph, both decodes
    bit-equal to the JAX package's."""
    blobs = [fixture(n) for n in MIXED]
    with DeviceStreamDecoder(device="cpu", host_threads=1,
                             precision="exact") as dec:
        outs, graphs_of = [], []
        for comp in ((1, 0, 2), (2, 0, 1)):
            group = [dec.stage(blobs[i]) for i in comp]
            halves = dec._group_wires("bits", group)
            at = comp.index(1)
            graphs_of.append(halves.recons[at].graph)
            outs.append(dec._run_group("bits", group, halves)[at])
    assert graphs_of[0] is graphs_of[1]
    ref = _jax_images("exact")[1]
    for img in outs:
        assert _diff(img, ref) == 0


def test_a_part_of_three_pads_to_four():
    """mixed_500x375 three times beside two other sizes: its part graph
    holds 4 images (the count bucket), returns 3, each equal to the
    batch-1 decode (and to the halves run eagerly on the same inputs);
    its pad slot's table is the last image's."""
    blobs = [fixture(n) for n in MIXED]
    comp = COMPOSITIONS["a plan thrice"]
    with DeviceStreamDecoder(device="cpu", host_threads=1,
                             precision="exact") as dec:
        single = dec.decode_stream(blobs[:3])
        group = [dec.stage(blobs[i]) for i in comp]
        halves = dec._group_wires("bits", group)
        out = dec._run_group("bits", group, halves)
        eager = dec._run_group_eager("bits", group, halves)
        graph = halves.recons[0].graph
    nb = group[0].scans[0].scan.plan.n_blocks
    assert graph.shape.images == 4 and graph.nat_in.shape == (4 * nb, 64)
    slots = graph.inputs.qts_b
    assert all(torch.equal(a.q_exact, b.q_exact)
               for a, b in zip(slots[3], slots[2]))
    assert all(torch.equal(a, b) for a, b in zip(out, eager))
    assert len(halves.parts[(group[0].scans[0].scan.plan,
                             group[0].geometry)]) == 3
    assert len(out) == len(comp)
    for i, img in zip(comp, out):
        assert torch.equal(img, single[i])


def test_a_refilled_arena_lands_its_inputs_again(monkeypatch):
    """Two compositions of one sweep key and the same part keys, both
    landed before either runs: each call lands its own inputs again (the
    other's filled every arena since), and decodes its own images."""
    landed = []
    real = graphs.put_into

    def spy(dst, items):
        landed.append(len(items))
        return real(dst, items)

    monkeypatch.setattr(graphs, "put_into", spy)
    blobs = [fixture(n) for n in MIXED]
    with DeviceStreamDecoder(device="cpu", host_threads=1,
                             precision="exact") as dec:
        single = dec.decode_stream(blobs[:2])
        landed.clear()
        groups = [[dec.stage(blobs[i]) for i in comp]
                  for comp in ((0, 1), (1, 0))]
        halves = [dec._group_wires("bits", g) for g in groups]
        assert halves[0].sweep.graph is halves[1].sweep.graph
        assert {f.graph for f in halves[0].recons} == \
            {f.graph for f in halves[1].recons}
        assert len(landed) == 6
        outs = [dec._run_group("bits", g, h) for g, h in zip(groups, halves)]
    # The sweep and both parts land again for each group.
    assert len(landed) == 12
    assert all(torch.equal(a, b) for a, b in zip(outs[0], single))
    assert all(torch.equal(a, b) for a, b in zip(outs[1], single[::-1]))

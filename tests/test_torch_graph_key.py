"""The compiled dispatch's key (`models/graphs.py::bits_key`) against the JAX
package's compile key, and the static-buffer body against the JAX package,
on the CPU.

The JAX package compiles its bits device half once per key
(`_compiled_bits_pipeline`, an `lru_cache` of `jax.jit`): the plans with
their kept components, the component count, the geometry, the layout and
per scan the Pallas class shapes `(slot_words, s_max, n_bucket)`, n_tab,
`comp_to_upair` and the wire (`_bits_fn_args`, `stream.py:1400-1421`),
and `jax.jit` keys its trace on the runtime arguments' shapes too: the
wire's bucketed words, per-chunk words and class counts. Here the JAX
key is computed from the JAX package's own staging and its own
`entropy/pallas_decode.py::pack_delta` on the same bytes (its Pallas path
is off on the CPU, so the shapes come from `pack_delta`, not from a
decode). Over pairs of fixtures (large_420 with itself, tower_420 with
tower_420_q92 and with `optimized/tower_420_opt.jpg`, the mixed sizes with
each other, the small fixtures across samplings), two images share
`bits_key` exactly when they share the JAX key.
`optimized/tower_420_opt.jpg` is tower_420's array with per-image
optimised Huffman tables: it must share tower_420's key, and one graph.

The static-buffer body (every input in a graph's arena, the tables
included) runs eagerly on the CPU through the kernels' plain versions, as
`DeviceStreamDecoder` runs it there: pixels bit-equal at exact to the JAX
package's `DeviceStreamDecoder` and to the host's exact decode, within 3 at
fast (an fp32 IDCT 1 off, times up to 1.772 through color), for images
alternating through one key and for a same-key group in every layout; a
call whose arena another call refilled before it ran lands its inputs
again; every call lands its whole arena, tables included; the cache
holds at most its bound. On the CPU every call of a key goes through its
graph's arena (on a card a key's first call runs off any graph).
"""

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu import Decoder
from jpeg_decoder_tpu.entropy.pallas_decode import pack_delta as jax_pack_delta
from jpeg_decoder_tpu.models.stream import \
    DeviceStreamDecoder as JaxStreamDecoder
from jpeg_decoder_tpu.models.stream import \
    stage_host_bits as jax_stage_host_bits
from jpeg_decoder_tpu_torch import DeviceStreamDecoder, stage_host_bits
from jpeg_decoder_tpu_torch.models import graphs

from torch_inputs import SMALL_FIXTURES, fixture

OPT = "optimized/tower_420_opt.jpg"
MIXED = ("mixed_500x375.jpg", "mixed_375x500.jpg", "mixed_500x333.jpg",
         "mixed_333x500.jpg", "mixed_448x448.jpg", "mixed_320x240.jpg")
PAIRS = ([("large_420.jpg", "large_420.jpg"),
          ("tower_420.jpg", "tower_420_q92.jpg"), ("tower_420.jpg", OPT),
          ("tower_420_q92.jpg", OPT), ("tower_420.jpg", "tower_420.jpg")]
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


def jax_key(data: bytes, precision: str, layout: str) -> tuple:
    """What `_compiled_bits_pipeline` is keyed on, with the shapes of the
    wire that `jax.jit` traces: from the JAX package's staging and its
    `pack_delta` (a scan it declines: its plan and anchor arrays' shapes,
    which key the XLA engine's trace)."""
    st = jax_stage_host_bits(data, None, precision)
    scans = []
    for scan, _kept in st.scans:
        packed = jax_pack_delta(scan)
        if packed is None:
            scans.append(("xla", scan.words.shape, scan.anchor_bits.shape))
            continue
        (words, dm, cnts), shapes = packed
        scans.append(((tuple(s[:3] for s in shapes),
                       len(scan.tab_maxcode), tuple(scan.comp_to_upair),
                       "delta"), words.shape, dm.shape, cnts.shape))
    return (tuple((scan.plan, kept) for scan, kept in st.scans),
            len(st.qts), st.geometry, layout, tuple(scans))


def port_key(data: bytes, precision: str, layout: str) -> tuple:
    return graphs.bits_key(stage_host_bits(data, None, precision), precision,
                           layout)


@pytest.mark.parametrize("a,b", PAIRS, ids=[f"{a}~{b}" for a, b in PAIRS])
def test_key_shared_exactly_when_the_jax_key_is(a, b):
    for precision in ("fast", "exact"):
        da, db = fixture(a), fixture(b)
        same_jax = jax_key(da, precision, "interleaved") == jax_key(
            db, precision, "interleaved")
        same_port = port_key(da, precision, "interleaved") == port_key(
            db, precision, "interleaved")
        assert same_port == same_jax, (precision, same_port, same_jax)


def test_optimised_tables_share_tower_420s_key():
    """The optimised-table fixture: other Huffman and quantisation tables,
    tower_420's key, in JAX as in the port."""
    tower, opt = fixture("tower_420.jpg"), fixture(OPT)
    st_t, st_o = stage_host_bits(tower), stage_host_bits(opt)
    assert st_t.scans[0].scan.tab_values.tobytes() \
        != st_o.scans[0].scan.tab_values.tobytes()
    assert not all(np.array_equal(a, b) for a, b in zip(st_t.qts, st_o.qts))
    assert port_key(tower, "fast", "interleaved") \
        == port_key(opt, "fast", "interleaved")
    assert jax_key(tower, "fast", "interleaved") \
        == jax_key(opt, "fast", "interleaved")


def _jax_images(data: list, **kw) -> list:
    return [np.asarray(img) for img in JaxStreamDecoder(
        host_threads=2, interchange="bits", **kw).decode_stream(data)]


def _exact(data: bytes) -> np.ndarray:
    return Decoder(data, backend="numpy", precision="exact").decode_array()


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_body_through_one_key_against_jax(precision):
    """tower_420, the optimised fixture and tower_420_q92 alternating on
    one decoder: tower_420 and the optimised fixture through one graph
    (its arena refilled with the other's wire and tables each call),
    tower_420_q92 through its own; every image bit-equal to the JAX
    package (exact) or within FAST_TOL of it (fast)."""
    names = ["tower_420.jpg", OPT, "tower_420_q92.jpg", OPT,
             "tower_420.jpg"]
    data = [fixture(n) for n in names]
    with DeviceStreamDecoder(device="cpu", host_threads=2,
                             precision=precision) as dec:
        port = dec.decode_stream(data)
        assert dec._graphs.stats()["graphs"] == 2
    ref = _jax_images(data, precision=precision)
    for name, d, p, r in zip(names, data, port, ref):
        assert tuple(p.shape) == r.shape, name
        diff = int(np.abs(p.numpy().astype(np.int32)
                          - r.astype(np.int32)).max())
        if precision == "exact":
            assert diff == 0, name
            np.testing.assert_array_equal(p.numpy(), _exact(d),
                                          err_msg=name)
        else:
            assert diff <= FAST_TOL, (name, diff)


@pytest.mark.parametrize("layout", ["interleaved", "planar",
                                    "planar-pallas"])
def test_body_on_a_group_and_the_layouts(layout):
    """small_444 and tower_420 one by one and tower_420 x 3 as one
    same-key group, at exact in every layout: equal to the JAX package's
    decode (bit-equal on the interleaved and planar layouts; planar-pallas
    runs the fp32 IDCT at either precision, as the JAX package's does:
    within FAST_TOL), each group image bit-equal to its one-image
    decode."""
    names = ["small_444.jpg", "tower_420.jpg"]
    data = [fixture(n) for n in names]
    with DeviceStreamDecoder(device="cpu", host_threads=1,
                             precision="exact", layout=layout) as dec:
        port = dec.decode_stream(data)
        group = dec.decode_stream([data[1]] * 3, batch_size=3)
        kinds = sorted(k[0] for k in dec._graphs._graphs)
    assert kinds == ["group", "image", "image"]
    assert all(torch.equal(g, port[1]) for g in group)
    ref = _jax_images(data, precision="exact", layout=layout)
    tol = FAST_TOL if layout == "planar-pallas" else 0
    for name, p, r in zip(names, port, ref):
        assert tuple(p.shape) == r.shape, name
        diff = int(np.abs(p.numpy().astype(np.int32)
                          - r.astype(np.int32)).max())
        assert diff <= tol, (name, diff)


def test_a_refilled_arena_lands_its_inputs_again():
    """Two calls of one key submitted before either runs: the second's
    inputs overwrite the arena, so the first call lands its own again
    before it runs."""
    tower, opt = fixture("tower_420.jpg"), fixture(OPT)
    with DeviceStreamDecoder(device="cpu", host_threads=1,
                             precision="exact") as dec:
        st_t, st_o = dec.stage(tower), dec.stage(opt)
        fill_t = dec._to_device(st_t)
        fill_o = dec._to_device(st_o)
        assert fill_t.graph is fill_o.graph
        got_t = dec._run_device(st_t, fill_t)
        got_o = dec._run_device(st_o, fill_o)
        eager_t = dec._run_device_eager(st_t, fill_t)
    np.testing.assert_array_equal(got_t.numpy(), _exact(tower))
    np.testing.assert_array_equal(got_o.numpy(), _exact(opt))
    assert torch.equal(eager_t, got_t)


def test_cache_bound_and_counts():
    """At most `maxsize` graphs, the least recently used evicted; one
    graph per key."""
    names = ["tower_420.jpg", "small_444.jpg", "small_gray.jpg",
             "tower_420.jpg"]
    with DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
        dec._graphs.maxsize = 2
        dec.decode_stream([fixture(n) for n in names])
        keys = [k[2][0][0].n_blocks for k in dec._graphs._graphs]
        assert len(dec._graphs) == 2
        assert keys[-1] == stage_host_bits(fixture(
            "tower_420.jpg")).scans[0].scan.plan.n_blocks
    assert graphs.GRAPH_CACHE_SIZE <= 128


def test_every_call_lands_its_whole_arena(monkeypatch):
    """Every call lands its wire and its tables in one copy, whether or
    not the arena holds those tables already (one encoder's images), and
    decodes its own image. Exact precision: per scan 2 wire arrays and 7
    tables' (K1's six and the zigzag map), per component one int32
    table."""
    landed = []
    real = graphs.put_into

    def spy(dst, items):
        landed.append(len(items))
        return real(dst, items)

    monkeypatch.setattr(graphs, "put_into", spy)
    tower, opt = fixture("tower_420.jpg"), fixture(OPT)
    names = [tower, tower, opt, opt, tower]
    with DeviceStreamDecoder(device="cpu", host_threads=1,
                             precision="exact") as dec:
        out = dec.decode_stream(names)
        assert dec._graphs.stats() == {"graphs": 1, "captures": 0,
                                       "hits": 0, "eager": 5}
    assert landed == [12] * 5
    for data, img in zip(names, out):
        np.testing.assert_array_equal(img.numpy(), _exact(data))


def test_first_sight_on_a_card_only():
    """`first_sight`: on a card a key's first call runs off any graph and
    its second gets one; a key forgotten among more than `maxsize` later
    first sights is new again, so keys cycled past the bound never get a
    graph; on the CPU every call goes through the graph."""
    card = graphs.BitsGraphs(torch.device("cuda"), None, None)
    card.maxsize = 3
    assert [card.first_sight(k) for k in "aab"] == [True, False, True]
    assert all(card.first_sight(k) for k in "cdefcdefcdef")
    cpu = graphs.BitsGraphs(torch.device("cpu"), None, None)
    assert not any(cpu.first_sight(k) for k in "aab")

"""The compiled dispatch on the mesh and in `Decoder` (`models/graphs.py`:
the "stripes", "stripe_recon" and "recon" kinds, and a graph cache per
device for the data-parallel shards) against the JAX package, on the CPU.

The JAX package compiles these programs once per key: a line of stripes,
entropy included (`_compiled_stripe_bits_xla{,_batch}`, `lru_cache`s of
`jax.jit` keyed on the stripe plan, the kept components, the component
count, the geometry, the MCU rows, the stripe count and the batch, with
the split's arrays' shapes traced), the striped and the batched
reconstructions (`make_stripe_pipeline`, `make_batch_pipeline`: the
geometry, the MCU rows and stripe count, the batch traced) and `Decoder`'s
reconstruction (`_compiled_pipeline`, keyed on the geometry). Here:
- the keys: two images share the port's key exactly when they share the
  JAX key, over fixture pairs at 4 and 8 stripes, and two images of one
  plan and other content share one;
- the padded stripe wire (`padded_stripe_wire`: the split's buckets, the
  pad chunks of budget 0 at the stripe's end);
- the "stripes" body on the padded wires (K1 at the plan's step bound)
  bit-equal to the eager body on the real wires, to the host's exact
  decode and to the JAX package's `decode_bits_striped` (large_420.jpg
  and stripe_420.jpg, whose 8-stripe split starts stripes inside chunks);
  DP x SP likewise;
- the "recon" body bit-equal to JAX `reconstruct_image(backend="jax")` at
  exact and within 3 at fast, through the process's cache of the device
  (`graphs.device_graphs`), which `Decoder` and `make_batch_pipeline`
  share;
- the predicate that keeps a line over several devices eager, on its own
  and on a line it turns down;
- two threads on one device's cache, each decoding its own image of one
  key, each getting its own image;
- every mesh group (bits, prefix, lossless, planar-pallas) through the
  decoder's cache of its shard's device, each shard an image of its own
  (`requantized`: one key, other pixels), bit-equal to the meshless
  decode.
On the CPU every call lands its inputs in its key's graph and runs the
body eagerly on them, so these tests run what a card replays. The
process's cache is shared by every test of a worker: the tests count the
fills of their own keys.
"""

import hashlib
import threading

import numpy as np
import pytest
import torch

import jpeg_decoder_tpu_torch as jt
from jpeg_decoder_tpu.models.stream import stage_host_bits as jax_stage
from jpeg_decoder_tpu.ops.pipeline import reconstruct_image as jax_recon
from jpeg_decoder_tpu.parallel.stripe_bits import (
    decode_bits_striped as jax_striped,
    decode_bits_striped_batch as jax_striped_batch,
    split_anchored_stripes as jax_split)
from jpeg_decoder_tpu_torch import decoder as port_decoder
from jpeg_decoder_tpu_torch.models import graphs
from jpeg_decoder_tpu_torch.parallel import (make_batch_pipeline, make_mesh,
                                             make_stripe_pipeline)
from jpeg_decoder_tpu_torch.parallel import stripe_bits
from jpeg_decoder_tpu_torch.parallel.mesh import Mesh, gather_rows
from jpeg_decoder_tpu_torch.parallel.stripes import _pad_rows

from test_torch_batch import _one_torch_thread  # noqa: F401
from test_torch_mesh import _jax_mesh, _ref_geometry, _stores
from tools.make_torch_fixtures import requantized, sof3_jpeg, sof3_samples
from torch_inputs import fixture, stripe_jpeg

OPT = "optimized/tower_420_opt.jpg"
STRIPE_PAIRS = [("large_420.jpg", "large_420.jpg"),
                ("tower_420.jpg", "tower_420_q92.jpg"),
                ("tower_420.jpg", OPT), ("tower_420.jpg", "stripe_420.jpg"),
                ("stripe_420.jpg", "stripe_420.jpg"),
                ("mixed_500x375.jpg", "mixed_375x500.jpg"),
                ("mixed_448x448.jpg", "mixed_448x448.jpg"),
                ("small_444.jpg", "small_422.jpg"),
                ("small_gray.jpg", "small_gray.jpg")]
RECON_PAIRS = [("tower_420.jpg", "tower_420_q92.jpg"), ("tower_420.jpg", OPT),
               ("large_420.jpg", "tower_420.jpg"),
               ("small_444.jpg", "small_422.jpg"),
               ("mixed_500x375.jpg", "mixed_500x333.jpg"),
               ("small_gray.jpg", "small_gray.jpg")]
FAST_TOL = 3


def _fills(key) -> int:
    """How often the process's CPU cache has landed a call in `key`'s
    graph (0: no graph)."""
    graph = graphs.device_graphs("cpu")._graphs.get(key)
    return 0 if graph is None else graph.fill_id


def jax_stripes_key(data: bytes, n: int):
    """What `_compiled_stripe_bits_xla_batch` is keyed on for a line of one
    image, with the shapes `jax.jit` traces of the split's arrays (words,
    anchor arrays, LUTs); None where the JAX split declines."""
    st = jax_stage(data)
    scan, kept = st.scans[0]
    split = jax_split(scan, n)
    if split is None:
        return None
    return (split.plan, tuple(kept), len(st.qts), st.geometry,
            split.mcu_rows, n, 1, split.words.shape,
            split.anchor_bits.shape, split.anchor_block.shape,
            split.luts.shape)


def port_stripes_key(data: bytes, n: int):
    st = jt.stage_host_bits(data)
    split = stripe_bits._split_one(st, n)
    return None if split is None else graphs.stripes_key([st], split)


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("a,b", STRIPE_PAIRS,
                         ids=[f"{a}~{b}" for a, b in STRIPE_PAIRS])
def test_stripes_key_shared_exactly_when_the_jax_key_is(a, b, n):
    ja, jb = jax_stripes_key(fixture(a), n), jax_stripes_key(fixture(b), n)
    pa, pb = port_stripes_key(fixture(a), n), port_stripes_key(fixture(b), n)
    assert (pa is None) == (ja is None) and (pb is None) == (jb is None)
    if ja is not None and jb is not None:
        assert (pa == pb) == (ja == jb), (pa == pb, ja == jb)


def _same_plan_pair(n: int) -> tuple:
    """Two seeded images of one size whose stripe plans (buckets included)
    are one: the first pair of seeds whose JAX keys agree."""
    datas = [stripe_jpeg(208, 256, "RGB", 500 + s, subsampling=2)
             for s in range(6)]
    keys = [jax_stripes_key(d, n) for d in datas]
    for i in range(len(datas)):
        for j in range(i + 1, len(datas)):
            if keys[i] == keys[j]:
                return datas[i], datas[j]
    raise AssertionError("no two seeds share a stripe plan")


def test_same_plan_other_content_shares_a_stripes_key_and_graph():
    a, b = _same_plan_pair(4)
    assert a != b
    key = port_stripes_key(a, 4)
    assert key == port_stripes_key(b, 4)
    before = _fills(key)
    mesh = make_mesh({"stripe": 4}, ["cpu"] * 4)
    for data in (a, b):
        got = stripe_bits.decode_bits_striped(jt.stage_host_bits(data), mesh)
        assert np.array_equal(got.numpy(), _gold(data))
    assert _fills(key) == before + 2


def _gold(data: bytes) -> np.ndarray:
    return jt.host.decoder.Decoder(data, backend="numpy").decode_array()


@pytest.mark.parametrize("a,b", RECON_PAIRS,
                         ids=[f"{a}~{b}" for a, b in RECON_PAIRS])
def test_recon_and_stripe_recon_keys_shared_exactly_when_jax_keys_are(a, b):
    """`recon_key` against `_compiled_pipeline`'s geometry (and the batch
    `make_batch_pipeline` traces), `stripe_recon_key` against
    `make_stripe_pipeline`'s (geometry, MCU rows, stripe count) and the
    batch, at both precisions."""
    for precision in ("exact", "fast"):
        ga, _s, _q, rows_a, _g = _stores(fixture(a), precision)
        gb, _s, _q, rows_b, _g = _stores(fixture(b), precision)
        same_jax = _ref_geometry(ga) == _ref_geometry(gb)
        assert (graphs.recon_key(ga, 1) == graphs.recon_key(gb, 1)) \
            == same_jax
        assert (graphs.recon_key(ga, 2) == graphs.recon_key(gb, 2)) \
            == same_jax
        for n in (4, 8):
            same = (_ref_geometry(ga), rows_a, n) \
                == (_ref_geometry(gb), rows_b, n)
            assert (graphs.stripe_recon_key(ga, rows_a, n, 1)
                    == graphs.stripe_recon_key(gb, rows_b, n, 1)) == same
    g, *_rest = _stores(fixture(a))
    assert graphs.recon_key(g, 1) != graphs.recon_key(g, 2)
    assert graphs.stripe_recon_key(g, 8, 4, 1) \
        != graphs.stripe_recon_key(g, 8, 4, 2)


@pytest.mark.parametrize("name,n", [("large_420.jpg", 8),
                                    ("stripe_420.jpg", 8),
                                    ("stripe_420.jpg", 4)])
def test_padded_stripe_wire(name, n):
    """Each stripe's padded wire: the split's word and chunk buckets, the
    real chunks as `stripe_wire` gives them, then budget-0 chunks at entry
    bit 0 whose first block is the stripe's end; first blocks
    nondecreasing."""
    split = stripe_bits._split_one(jt.stage_host_bits(fixture(name)), n)
    negative = 0
    for d in range(n):
        (words, dm, ab, base), _s = stripe_bits.stripe_wire(split, d)
        pw, pdm, pab, pbase = stripe_bits.padded_stripe_wire(split, d)
        m = len(dm)
        assert pw.shape == (split.words.shape[1],)
        assert pdm.shape == pab.shape == pbase.shape \
            == (split.anchor_bits.shape[1],)
        assert np.array_equal(pw[:len(words)], words)
        assert not pw[split.n_words[d]:].any()
        assert np.array_equal(pdm[:m], dm) and np.array_equal(pab[:m], ab)
        assert np.array_equal(pbase[:m], base)
        assert not pdm[m:].any() and not pab[m:].any()
        assert (pbase[m:] == split.n_blocks_local).all()
        assert np.all(np.diff(pbase) >= 0)
        negative += int(m > 0 and base[0] < 0)
    if name == "stripe_420.jpg" and n == 8:
        assert negative >= 4


def _eager_striped(staged_list, splits, mesh) -> torch.Tensor:
    """The eager body on the real stripe wires, the rows gathered."""
    devs = mesh.axis_devices("stripe")
    outs = stripe_bits._decode_stripes(staged_list, splits, devs, mesh)
    return gather_rows([o for _, o in stripe_bits._crop_rows(
        outs, range(len(devs)), staged_list[0].geometry.out_height)],
        mesh.first, dim=1)


@pytest.mark.parametrize("name,n", [("large_420.jpg", 4),
                                    ("large_420.jpg", 8),
                                    ("stripe_420.jpg", 4),
                                    ("stripe_420.jpg", 8)])
def test_stripes_body_on_padded_wires_bit_equal(name, n):
    """`decode_bits_striped` through its `stripes` graph (the padded wires,
    K1 at the plan's step bound, in one arena) against the eager body on
    the real wires and the host's exact decode; at 8 stripes also against
    the JAX package's; `DeviceStreamDecoder.decode_striped` through the
    same graph."""
    data = fixture(name)
    staged = jt.stage_host_bits(data)
    split = stripe_bits._split_one(staged, n)
    key = graphs.stripes_key([staged], split)
    before = _fills(key)
    mesh = make_mesh({"stripe": n}, ["cpu"] * n)
    got = stripe_bits.decode_bits_striped(staged, mesh)
    assert _fills(key) == before + 1
    eager = _eager_striped([staged], [split], mesh)[0]
    assert torch.equal(got, eager)
    assert np.array_equal(got.numpy(), _gold(data))
    if n == 8:
        want = jax_striped(jax_stage(data), _jax_mesh({"stripe": n}),
                           engine="xla")
        assert np.array_equal(got.numpy(), np.asarray(want))
    with jt.DeviceStreamDecoder(mesh=mesh, host_threads=1) as dec:
        assert torch.equal(dec.decode_striped(data), got)
    assert _fills(key) == before + 2


def test_dp_sp_lines_share_one_stripes_graph():
    """Four tower_420-class images over {"data": 2, "stripe": 2}: both
    data lines land in one key's graph (two fills), bit-equal to the eager
    body, the host decode and the JAX package's DP x SP batch."""
    datas = [stripe_jpeg(200, 240, "RGB", 200 + i, subsampling=2)
             for i in range(4)]
    staged = [jt.stage_host_bits(d) for d in datas]
    splits = [stripe_bits._split_one(st, 2) for st in staged]
    key = graphs.stripes_key(staged[:2], splits[0])
    assert graphs.stripes_key(staged[2:], splits[2]) == key
    before = _fills(key)
    mesh = make_mesh({"data": 2, "stripe": 2}, ["cpu"] * 4)
    got = stripe_bits.decode_bits_striped_batch(staged, mesh)
    assert _fills(key) == before + 2
    want = jax_striped_batch([jax_stage(d) for d in datas],
                             _jax_mesh({"data": 2, "stripe": 2}))
    assert np.array_equal(got.numpy(), np.asarray(want))
    line = make_mesh({"stripe": 2}, ["cpu"] * 2)
    for k in range(2):
        eager = _eager_striped(staged[2 * k:2 * k + 2],
                               splits[2 * k:2 * k + 2], line)
        assert torch.equal(got[2 * k:2 * k + 2], eager)
    for i, d in enumerate(datas):
        assert np.array_equal(got[i].numpy(), _gold(d)), i


def test_store_level_stripes_through_their_graph():
    """`make_stripe_pipeline` on a line of one device: its `stripe_recon`
    graph, bit-equal to the host decode, and a second call of the key
    into the same graph; DP x SP lines share the key."""
    geometry, stores, qts, mcu_rows, golden = _stores(
        fixture("tower_420.jpg"))
    key = graphs.stripe_recon_key(geometry, mcu_rows, 4, 1)
    before = _fills(key)
    mesh = make_mesh({"stripe": 4}, ["cpu"] * 4)
    fn = make_stripe_pipeline(geometry, mcu_rows, 4, mesh)
    padded = _pad_rows(geometry, stores, mcu_rows, 4, False)
    rows, cols = geometry.out_height, geometry.out_width
    for _ in range(2):
        out = fn(padded, tuple(qts))
        assert out[:rows, :cols].numpy().tobytes() == golden
    assert _fills(key) == before + 2
    key = graphs.stripe_recon_key(geometry, mcu_rows, 2, 2)
    before = _fills(key)
    grid = make_mesh({"data": 2, "stripe": 2}, ["cpu"] * 4)
    batched = _pad_rows(geometry, [np.broadcast_to(s, (4,) + s.shape)
                                   for s in stores], mcu_rows, 2, True)
    out = make_stripe_pipeline(geometry, mcu_rows, 2, grid,
                               data_axis="data")(batched, tuple(qts))
    assert all(img[:rows, :cols].numpy().tobytes() == golden for img in out)
    assert _fills(key) == before + 2


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("name", ["large_420.jpg", "tower_420.jpg",
                                  "small_444.jpg", "small_422.jpg",
                                  "small_gray.jpg", "small_cmyk_420.jpg"])
def test_recon_body_against_jax(name, precision):
    """`decoder.reconstruct_tensor` and `make_batch_pipeline` through
    their `recon` graphs of the process's CPU cache against JAX `reconstruct_image(backend="jax")`: bit-equal at exact,
    within 3 at fast."""
    geometry, stores, qts, _rows, _golden = _stores(fixture(name),
                                                   precision)
    want = np.asarray(jax_recon(_ref_geometry(geometry), stores, qts,
                                backend="jax")).astype(np.int32)
    before = _fills(graphs.recon_key(geometry, 1))
    got = port_decoder.reconstruct_tensor(geometry, stores, qts,
                                          torch.device("cpu"))
    assert _fills(graphs.recon_key(geometry, 1)) == before + 1
    before = _fills(graphs.recon_key(geometry, 2))
    mesh = make_mesh({"data": 2}, ["cpu"] * 2)
    batched = [np.broadcast_to(s, (4,) + s.shape) for s in stores]
    parts = make_batch_pipeline(geometry, mesh)(batched, qts)
    assert [tuple(p.shape)[0] for p in parts] == [2, 2]
    assert _fills(graphs.recon_key(geometry, 2)) == before + 2
    for out in [got] + [img for p in parts for img in p]:
        diff = np.abs(out.numpy().astype(np.int32) - want)
        assert diff.max() <= (0 if precision == "exact" else FAST_TOL)


def test_decoder_front_end_replays_its_recon_key():
    """`Decoder(device="cpu")` lands every image's stores in its geometry's
    graph (one per key, shared by the Decoders of the process), its stages
    named as before; exact output bit-equal to the host's."""
    data = fixture("tower_420.jpg")
    key = graphs.recon_key(_stores(data)[0], 1)
    before = _fills(key)
    timer = jt.StageTimer()
    outs = [jt.Decoder(data, device="cpu", timer=timer).decode_array()
            for _ in range(2)]
    assert all(np.array_equal(o, _gold(data)) for o in outs)
    assert _fills(key) == before + 2
    assert timer.counts["h2d_submit"] == timer.counts["device_dispatch"] \
        == timer.counts["d2h"] == 2


@pytest.mark.parametrize("devices,processes,line,want", [
    (["cpu"] * 4, 1, slice(None), True),
    (["cuda:0"] * 4, 1, slice(None), True),
    (["cuda:0", "cuda:0", torch.device("cuda", 0)], 1, slice(None), True),
    (["cuda:0", "cuda:1"], 1, slice(None), False),
    (["cuda:0"] * 2 + ["cuda:1"], 1, slice(None), False),
    (["cuda:0"] * 4, 2, slice(None), False),
    (["cpu", "cuda:0"], 1, slice(None), False),
    (["cuda:1", "cuda:0", "cuda:0"], 1, slice(1, None), False),
    (["cuda:0", "cuda:1", "cuda:1"], 1, slice(0, 1), True)])
def test_one_device_predicate(devices, processes, line, want):
    """A line (`line` of the mesh's entries) is one graph when its devices
    and the mesh's first, where its rows gather, are one device, in a
    mesh of one process."""
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    mesh = Mesh(arr, ("stripe",), processes=processes)
    assert graphs.one_device(mesh, list(arr[line])) is want


def test_a_line_over_several_devices_dispatches_eagerly(monkeypatch):
    """A line the predicate turns down runs the eager body, no graph made,
    the result the same as its graph's."""
    staged = jt.stage_host_bits(fixture("stripe_420.jpg"))
    key = graphs.stripes_key([staged], stripe_bits._split_one(staged, 4))
    graphed = make_mesh({"stripe": 4}, ["cpu"] * 4)
    want = stripe_bits.decode_bits_striped(staged, graphed)
    before = _fills(key)
    monkeypatch.setattr(graphs, "one_device", lambda *a, **k: False)
    mesh = make_mesh({"stripe": 4}, ["cpu"] * 4)
    got = stripe_bits.decode_bits_striped(staged, mesh)
    assert torch.equal(got, want) and _fills(key) == before


@pytest.mark.parametrize("shared_mesh", [True, False])
def test_threads_on_one_cache_each_get_their_own_image(shared_mesh):
    """Two threads decode their own image (tower_420 and a `requantized`
    variant: one stripes key, other pixels) over one or two meshes of CPU
    slots, so every call lands in one graph of the process's cache: each
    call's output is its own image's, however the threads' landings and
    runs interleave (the cache's lock holds from the arena's check
    through the run)."""
    datas = [requantized(fixture("tower_420.jpg"), step) for step in (0, 9)]
    staged = [jt.stage_host_bits(d) for d in datas]
    keys = {graphs.stripes_key([st], stripe_bits._split_one(st, 4))
            for st in staged}
    assert len(keys) == 1
    golds = [_gold(d) for d in datas]
    assert not np.array_equal(golds[0], golds[1])
    meshes = [make_mesh({"stripe": 4}, ["cpu"] * 4)]
    meshes.append(meshes[0] if shared_mesh
                  else make_mesh({"stripe": 4}, ["cpu"] * 4))
    wrong, errors = [], []
    start = threading.Barrier(2)

    def decode(i: int) -> None:
        try:
            start.wait()
            for call in range(6):
                got = stripe_bits.decode_bits_striped(staged[i], meshes[i])
                if not np.array_equal(got.numpy(), golds[i]):
                    wrong.append((i, call))
        except BaseException as exc:        # reported on the main thread
            errors.append(exc)

    before = _fills(keys.pop())
    threads = [threading.Thread(target=decode, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert not wrong, wrong
    assert _fills(graphs.stripes_key(
        [staged[0]], stripe_bits._split_one(staged[0], 4))) >= before + 12


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


def _sof3(seed: int) -> bytes:
    return sof3_jpeg(sof3_samples(64, 48, 1, 16, 0, seed=seed), 6, 0, 16)


def _variants() -> list:
    """Eight images of one key and other pixels: tower_420 `requantized`."""
    return [requantized(fixture("tower_420.jpg"), 3 * k) for k in range(8)]


MESH_GROUPS = {
    "bits": ({}, _variants),
    "prefix": ({"interchange": "prefix"}, _variants),
    "lossless": ({}, lambda: [_sof3(s) for s in range(8)]),
    "planar-pallas": ({"layout": "planar-pallas"}, _variants),
}


@pytest.mark.parametrize("kind", list(MESH_GROUPS))
def test_dp_shards_land_in_their_device_cache(kind):
    """A group of 8 images of one key and other content over {"data": 4}
    of CPU slots: one cache for the slots' one device, every shard landing
    in its key's graph (4 fills of one graph), every image bit-equal to
    its meshless decode, no two alike."""
    opts, make = MESH_GROUPS[kind]
    stream = make()
    with jt.DeviceStreamDecoder(device="cpu", host_threads=1,
                                **opts) as plain:
        single = plain.decode_stream(stream)
    mesh = make_mesh({"data": 4}, ["cpu"] * 4)
    with jt.DeviceStreamDecoder(mesh=mesh, host_threads=1, **opts) as dec:
        assert list(dec._caches) == [torch.device("cpu")]
        out = dec.decode_stream(stream, batch_size=8)
        fills = [g.fill_id for g in dec._graphs._graphs.values()]
    assert fills == [4]
    digests = [_digest(o) for o in out]
    assert digests == [_digest(o) for o in single]
    assert len(set(digests)) == 8

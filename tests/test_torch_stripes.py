"""The port's entropy-included stripes (`jpeg_decoder_tpu_torch.parallel.
stripe_bits`) against the JAX package's, on CPU meshes: the port's on
`make_mesh(..., devices=["cpu"] * n)`, the JAX package's on the conftest's
8-device virtual CPU mesh (engine "xla").

- The plain K1 drops a straddling chunk's lead-in (its first block is
  negative on a stripe's wire): stripe 2 of the seed-101 488x648 4:2:0
  image at 8 stripes equals rows [2 * 984, 3 * 984) of the whole image's
  `nat`, rows 982-983 included (before the repair, `index_put_` wrapped
  the lead-in into the last rows).
- The host split (`split_anchored_stripes`): every array and the plan key
  equal to the reference's, and None where the reference declines.
- The stripe wire: every budget and slot inside the anchor wire's fields.
- The DC seam carry in both assemblers, and none for restart segments;
  `dc_totals` (D1's wrapper) equal to `dc_totals_plain`, refusing plans
  without the closed form and devices without D1; K1 into the rows of a
  stripe's nat (`decode_chunks(out=)`) equal to the allocating call.
- `decode_bits_striped`: bit-equal to the reference's and to the host
  copy's `Decoder(backend="numpy")` over the reference's stripe cases
  (`tests/test_stripe_bits.py:55-69`) and one with empty stripes; DP x SP
  (`decode_bits_striped_batch`) bit-equal to the reference's.
Inputs are PIL images from seeds (`torch_inputs.stripe_jpeg`).
"""

import numpy as np
import pytest
import torch

import jpeg_decoder_tpu_torch as jt
from jpeg_decoder_tpu.models.stream import stage_host_bits as ref_stage
from jpeg_decoder_tpu.parallel.stripe_bits import (
    decode_bits_striped as ref_decode_bits_striped,
    decode_bits_striped_batch as ref_decode_bits_striped_batch,
    split_anchored_stripes as ref_split)
from jpeg_decoder_tpu_torch.entropy.assemble import (GeneralMaps,
                                                     assemble_general,
                                                     assemble_structured,
                                                     dc_totals,
                                                     dc_totals_plain)
from jpeg_decoder_tpu_torch.entropy.chunk_decode import (decode_chunks,
                                                         decode_chunks_plain)
from jpeg_decoder_tpu_torch.host.decoder import Decoder as HostDecoder
from jpeg_decoder_tpu_torch.host.entropy import prescan
from jpeg_decoder_tpu_torch.parallel import make_mesh
from jpeg_decoder_tpu_torch.parallel.stripe_bits import (
    decode_bits_striped, decode_bits_striped_batch, split_anchored_stripes,
    stripe_wire)
from jpeg_decoder_tpu_torch.params import scan_tables

from test_torch_batch import _one_torch_thread  # noqa: F401
from torch_inputs import STRIPE_CASES, fixture, stripe_case, stripe_jpeg

CASE_NAMES = [c[0] for c in STRIPE_CASES]


def _jax_mesh(shape: dict):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(list(shape.values())))
    return Mesh(np.array(jax.devices("cpu")[:n]).reshape(
        tuple(shape.values())), tuple(shape))


def _gold(data: bytes) -> np.ndarray:
    return HostDecoder(data, backend="numpy").decode_array()


def test_plain_k1_drops_a_straddlers_lead_in():
    """Stripe 2's wire (the reference's split, its first base -3) through
    the plain K1 equals the whole image's nat on the stripe's rows. The
    whole image's rows come from the image's own chunks that cover them,
    on its anchor wire (chunks decode independently)."""
    data, n = stripe_case("420")
    full = jt.stage_host_bits(data).scans[0].scan
    tables = scan_tables(full, "cpu")
    split = ref_split(ref_stage(data).scans[0][0], n)
    d, nb = 2, split.n_blocks_local
    assert nb == 984
    lo, hi = d * nb, (d + 1) * nb

    blk = full.anchor_block[:full.n_items + 1].astype(np.int64)
    i0 = int(np.searchsorted(blk[:-1], lo, side="right")) - 1
    i1 = int(np.searchsorted(blk[:-1], hi, side="left"))
    whole = decode_chunks_plain(
        torch.from_numpy(full.words[:full.n_words].view(np.int32)),
        torch.from_numpy(((blk[i0 + 1:i1 + 1] - blk[i0:i1]) << 4
                          | full.anchor_slot[i0:i1]).astype(np.int32)),
        torch.from_numpy(full.anchor_bits[i0:i1].view(np.int32)),
        torch.from_numpy(blk[i0:i1].astype(np.int32)), tables,
        full.plan.s_max, hi)

    ablk = split.anchor_block[d].astype(np.int64)
    m = int(np.flatnonzero(ablk[:-1] != ablk[-1])[-1]) + 1
    assert ablk[0] < 0, "stripe 2 must begin inside a chunk"
    nat = decode_chunks_plain(
        torch.from_numpy(split.words[d].view(np.int32)),
        torch.from_numpy(((ablk[1:m + 1] - ablk[:m]) << 4
                          | split.anchor_slot[d, :m]).astype(np.int32)),
        torch.from_numpy(split.anchor_bits[d, :m].view(np.int32)),
        torch.from_numpy(ablk[:m].astype(np.int32)), tables,
        full.plan.s_max, nb)
    want = whole[lo:hi]
    assert torch.equal(nat[nb - 2:], want[nb - 2:]), "rows 982-983"
    assert torch.equal(nat, want)


def test_stripe_fixture_is_the_seed_101_case():
    """The card tests read the "420" case from the committed fixture (the
    card machine has no PIL)."""
    assert fixture("stripe_420.jpg") == stripe_case("420")[0]


def test_plain_k1_with_no_chunk_is_zero():
    """An empty stripe (no chunk) decodes to zeros, as the kernel's memset
    leaves it."""
    data, _n = stripe_case("444-empty-stripes")
    scan = jt.stage_host_bits(data).scans[0]
    empty = torch.zeros(0, dtype=torch.int32)
    nat = decode_chunks(torch.zeros(1, dtype=torch.int32), empty, empty,
                        empty, scan_tables(scan.scan, "cpu"), 1, 40)
    assert nat.shape == (40, 64) and not nat.any()


def test_k1_into_rows_of_a_larger_tensor():
    """`decode_chunks(out=)`: K1 writes one image's rows of a stripe's
    [b, n_blocks, 64] nat, equal to the allocating call, the other rows
    untouched; an `out` of the wrong shape, type or layout raises."""
    data, n = stripe_case("420")
    full = jt.stage_host_bits(data).scans[0].scan
    split = split_anchored_stripes(full, n)
    arrays, s_max = stripe_wire(split, 2)
    args = [torch.from_numpy(a) for a in arrays] + [
        scan_tables(full, "cpu"), s_max, split.n_blocks_local]
    want = decode_chunks(*args)
    nat = torch.full((3, split.n_blocks_local, 64), -7, dtype=torch.int16)
    got = decode_chunks(*args, out=nat[1])
    assert got.data_ptr() == nat[1].data_ptr() and torch.equal(nat[1], want)
    assert (nat[0] == -7).all() and (nat[2] == -7).all()
    rows = torch.full_like(want, -7)
    assert torch.equal(decode_chunks_plain(*args, out=rows), want)
    assert torch.equal(rows, want)
    for bad in (nat[1, 1:], nat[1].to(torch.int32), nat[:, 0],
                torch.zeros((split.n_blocks_local, 128),
                            dtype=torch.int16)[:, ::2]):
        with pytest.raises(ValueError, match="out must be"):
            decode_chunks(*args, out=bad)


def test_dc_totals_takes_only_structured_plans_and_known_devices():
    (st,) = jt.stage_host_bits(fixture("small_444.jpg")).scans
    plan = st.scan.plan
    nat = torch.zeros((1, plan.n_blocks, 64), dtype=torch.int16)
    with pytest.raises(ValueError, match="no D1 implementation"):
        dc_totals(nat.to("meta"), plan)
    import copy
    general = copy.copy(plan)
    general.structured = None
    with pytest.raises(ValueError, match="structured form"):
        dc_totals(nat, general)


@pytest.mark.parametrize("name,restart", [("small_444.jpg", False),
                                          ("small_cmyk_420.jpg", False),
                                          ("small_dri.jpg", True)])
def test_dc_carry_in_assembly(name, restart):
    """`carry` adds to the DC of every real block of a non-segmented
    component, wrapped to int16, in both assemblers alike; padding blocks
    stay zero, AC is untouched, restart-segmented components take none;
    `dc_totals` is each component's DC diff sum."""
    (st,) = jt.stage_host_bits(fixture(name)).scans
    plan = st.scan.plan
    assert (plan.restart_interval > 0) == restart
    rng = np.random.default_rng(len(name))
    nat = torch.from_numpy(rng.integers(-900, 900, (2, plan.n_blocks, 64))
                           .astype(np.int16))
    carry = torch.from_numpy(rng.integers(-70000, 70000, (plan.ncomp, 2)))
    maps = GeneralMaps(plan, "cpu")
    plain = assemble_structured(nat, plan)
    got = assemble_structured(nat, plan, carry)
    got_general = assemble_general(nat, maps, carry)
    totals = dc_totals(nat, plan)
    assert torch.equal(dc_totals_plain(nat, plan), totals)
    assert torch.equal(dc_totals_plain(nat[1], plan), totals[1])
    for c in range(plan.ncomp):
        assert torch.equal(got[c], got_general[c])
        assert torch.equal(totals[:, c], nat[:, plan.stream_idx[c], 0].sum(
            -1, dtype=torch.int64))
        if restart:
            assert torch.equal(got[c], plain[c])
            continue
        real = torch.from_numpy(plan.raster_src[c] < len(plan.stream_idx[c]))
        delta = (got[c][..., 0].long() - plain[c][..., 0].long()) % 65536
        assert torch.equal(delta[:, real],
                           (carry[c][:, None] % 65536).expand(2, int(
                               real.sum())))
        assert not got[c][:, ~real].any()
        assert torch.equal(got[c][..., 1:], plain[c][..., 1:])


@pytest.mark.parametrize("name", CASE_NAMES)
def test_split_equals_the_reference(name):
    data, n = stripe_case(name)
    got = split_anchored_stripes(jt.stage_host_bits(data).scans[0].scan, n)
    want = ref_split(ref_stage(data).scans[0][0], n)
    for field in ("words", "anchor_bits", "anchor_block", "anchor_slot"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert got.plan._key == want.plan._key
    assert (got.n_stripes, got.mcu_rows, got.k_mcu, got.n_blocks_local) == (
        want.n_stripes, want.mcu_rows, want.k_mcu, want.n_blocks_local)
    assert np.array_equal(got.luts, want.luts)


@pytest.mark.parametrize("data,n", [
    (stripe_jpeg(512, 512, "RGB", 11, subsampling=2,
                 restart_marker_blocks=3), 4),       # unaligned DRI
    (stripe_jpeg(16, 16, "RGB", 4, subsampling=2), 4),   # too few rows
    (stripe_jpeg(64, 64, "RGB", 5, subsampling=2), 1),   # one stripe
])
def test_split_declines_where_the_reference_does(data, n):
    assert ref_split(ref_stage(data).scans[0][0], n) is None
    assert split_anchored_stripes(jt.stage_host_bits(data).scans[0].scan,
                                  n) is None


@pytest.mark.parametrize("name", CASE_NAMES)
def test_stripe_wire_fields(name):
    """Every stripe's wire passes the anchor wire's field check: real
    chunks decode 1-31 blocks, the truncated last chunk and the straddler
    included, and the budgets cover the stripe's real blocks."""
    data, n = stripe_case(name)
    staged = jt.stage_host_bits(data).scans[0].scan
    split = split_anchored_stripes(staged, n)
    negative = 0
    for d in range(n):
        (words, dm, ab, base), s_max = stripe_wire(split, d)
        budget = (dm.view(np.uint32) >> 4) & 31
        assert len(dm) == len(ab) == len(base) == split.n_items[d]
        assert s_max >= 1 and words.dtype == np.int32
        if not len(dm):
            continue
        assert budget.min() >= 1
        fill = min(split.n_blocks_local,
                   staged.n_blocks - d * split.n_blocks_local)
        assert int(base[0]) + int(budget.sum()) == fill
        assert np.all(np.diff(base) >= 0)
        negative += int(base[0] < 0)
    if name == "420":
        assert negative >= 4            # bases [0, 0, -3, 0, 0, -3, -3, -3]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_decode_bits_striped_bit_equal(name):
    data, n = stripe_case(name)
    got = decode_bits_striped(jt.stage_host_bits(data),
                              make_mesh({"stripe": n}, ["cpu"] * n))
    assert got is not None and got.dtype == torch.uint8
    gold = _gold(data)
    assert got.shape == gold.shape and np.array_equal(got.numpy(), gold)
    want = ref_decode_bits_striped(ref_stage(data),
                                   _jax_mesh({"stripe": n}), engine="xla")
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_decode_bits_striped_declines_and_engines():
    mesh = make_mesh({"stripe": 4}, ["cpu"] * 4)
    small = jt.stage_host_bits(stripe_jpeg(16, 16, "RGB", 4, subsampling=2))
    assert decode_bits_striped(small, mesh) is None
    assert decode_bits_striped(None, mesh) is None
    data, _n = stripe_case("420-mesh4-odd")
    with pytest.raises(ValueError, match="one engine"):
        decode_bits_striped(jt.stage_host_bits(data), mesh, engine="pallas")


def test_dp_sp_bits_batch_equals_the_reference():
    """Four same-layout images: DP over "data" (2) x stripes over "stripe"
    (4), each bit-equal to the reference's batch and the host decode."""
    datas = [stripe_jpeg(200, 240, "RGB", 200 + i, subsampling=2)
             for i in range(4)]
    got = decode_bits_striped_batch(
        [jt.stage_host_bits(d) for d in datas],
        make_mesh({"data": 2, "stripe": 4}, ["cpu"] * 8))
    want = ref_decode_bits_striped_batch(
        [ref_stage(d) for d in datas], _jax_mesh({"data": 2, "stripe": 4}))
    assert got is not None and got.shape == (4, 200, 240, 3)
    assert np.array_equal(got.numpy(), np.asarray(want))
    for i, d in enumerate(datas):
        assert np.array_equal(got[i].numpy(), _gold(d)), f"image {i}"


def test_dp_sp_bits_batch_compares_plans_by_key():
    """Equal plans built on either side of a plan-cache eviction are the
    same layout: the batch decodes (the reference compares identity and
    declines, ADVICE.md:3). A batch the data axis does not divide, or of
    different geometries, declines."""
    mesh = make_mesh({"data": 2, "stripe": 2}, ["cpu"] * 4)
    datas = [stripe_jpeg(96, 128, "RGB", 300 + i, subsampling=2)
             for i in range(2)]
    first = jt.stage_host_bits(datas[0])
    prescan._PLAN_CACHE.clear()
    second = jt.stage_host_bits(datas[1])
    assert first.scans[0].scan.plan is not second.scans[0].scan.plan
    got = decode_bits_striped_batch([first, second], mesh)
    assert got is not None
    for i, d in enumerate(datas):
        assert np.array_equal(got[i].numpy(), _gold(d))
    assert decode_bits_striped_batch([first], mesh) is None
    other = jt.stage_host_bits(stripe_jpeg(112, 128, "RGB", 7,
                                           subsampling=2))
    assert decode_bits_striped_batch([first, other], mesh) is None

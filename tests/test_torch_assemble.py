"""The assembly and the delta unpack of the PyTorch port (the plain versions
of kernels A1 and U1, `entropy/assemble.py::assemble_nat_plain` and
`entropy/chunk_decode.py::unpack_delta_plain`) against the JAX package on
what the fixture tests do not reach: block grids padded past the decoded
MCUs, restart segments across A1's tiles, groups of images with differing
DC, carries with high bits set, general maps no closed form describes
(`torch_inputs.A1_CASES`), both branches on every structured plan of the
fixtures, the DC carry of stripes against the reference's `_dc_carry`
arithmetic (every earlier stripe's diff total), and the delta unpack of a
group's merged wire. On the CPU `assemble_nat` and `unpack_delta` run
these plain versions; the card holds the kernels to them
(`tests/test_torch_cuda.py`, `chip_smoke.py` phase 25), and
`tests/test_torch_a1_replay.py` the kernels' own sources on the host.
Tolerance: bit-equal everywhere (integer code).
"""

import copy
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeg_decoder_tpu_torch as jt
from jpeg_decoder_tpu.entropy.device_scan import build_assembler_nat
from jpeg_decoder_tpu.entropy.pallas_decode import (merge_image_packs_delta,
                                                    pack_delta,
                                                    unpack_delta_classes)
from jpeg_decoder_tpu.models.stream import (
    stage_host_bits as reference_stage_host_bits)
from jpeg_decoder_tpu_torch.entropy import assemble
from jpeg_decoder_tpu_torch.entropy.assemble import (A1_ROWS, GeneralMaps,
                                                     assemble_nat,
                                                     assemble_nat_plain,
                                                     dc_totals)
from jpeg_decoder_tpu_torch.entropy.chunk_decode import (U1_TILE,
                                                         unpack_delta,
                                                         unpack_delta_plain)
from jpeg_decoder_tpu_torch.models.stream import merge_scans

from torch_inputs import (A1_CASES, ENTROPY_CASES, SMALL_FIXTURES, A1Plan,
                          a1_case, entropy_case, fixture)

CSRC = Path(assemble.__file__).resolve().parent.parent / "csrc"


def _reference(plan, nat: np.ndarray, branch: str, monkeypatch) -> list:
    """`build_assembler_nat` per image of nat [N, n_blocks, 64], on the
    branch asked for: [N, rows, 64] per component."""
    monkeypatch.setenv("JPEG_TPU_STRUCT_ASM",
                       "1" if branch == "structured" else "0")
    fn = build_assembler_nat(plan, flat_stores=False)
    per_image = [[np.asarray(s) for s in fn(jnp.asarray(x))] for x in nat]
    return [np.stack([img[c] for img in per_image])
            for c in range(plan.ncomp)]


def _with_carry(plan, ref: list, carry: np.ndarray) -> list:
    """The reference's stores with `_dc_carry`'s value added: the carry
    joins the int32 prefix sums before the int16 narrowing, so it adds mod
    2^16 to the DC of every real block of a component that takes one (no
    restart segments: `seg_blocks == 0`, or no restart interval on the
    general branch)."""
    out = []
    for c, store in enumerate(ref):
        store = store.copy()
        if plan.structured is not None:
            takes = plan.structured[1][c][6] == 0
        else:
            takes = plan.restart_interval == 0
        if takes:
            real = plan.raster_src[c] < len(plan.stream_idx[c])
            add = (carry[c].astype(np.int64) % 65536)[:, None]
            dc = store[:, real, 0].astype(np.int64) + add
            store[:, real, 0] = ((dc + 32768) % 65536 - 32768).astype(
                np.int16)
        out.append(store)
    return out


@pytest.mark.parametrize("case", A1_CASES, ids=[c[0] for c in A1_CASES])
def test_a1_plain_bit_equal_to_build_assembler_nat(case, monkeypatch):
    """Every seeded plan, each image of the group against the reference run
    on it alone, with and without its carry; the structured ones through
    both branches."""
    plan, nat, carry = a1_case(case)
    branches = ["general"] if plan.structured is None else ["structured",
                                                           "general"]
    for branch in branches:
        ref = _reference(plan, nat, branch, monkeypatch)
        maps = GeneralMaps(plan, "cpu")
        run = (lambda c: assemble_nat_plain(torch.from_numpy(nat), plan,
                                            None, c)) \
            if branch == "structured" else (
                lambda c: assemble.assemble_general(torch.from_numpy(nat),
                                                    maps, c))
        for got, want in zip(run(None), ref):
            np.testing.assert_array_equal(got.numpy(), want)
        if carry is not None:
            want = _with_carry(plan, ref, carry)
            for got, w in zip(run(torch.from_numpy(carry)), want):
                np.testing.assert_array_equal(got.numpy(), w)


def _fixture_plans():
    plans = []
    for name in SMALL_FIXTURES + ("tower_420.jpg", "stripe_420.jpg"):
        plans.append((name, jt.stage_host_bits(fixture(name))))
    for name in ENTROPY_CASES:
        plans.append((f"entropy {name}", jt.stage_host_bits(
            entropy_case(name))))
    return plans


@pytest.mark.parametrize("name,staged", _fixture_plans(),
                         ids=[n for n, _s in _fixture_plans()])
def test_both_branches_on_every_structured_plan(name, staged, monkeypatch):
    """Every fixture's plan: the closed form, and a copy of the plan without
    it through the general maps, each against the reference's same branch
    on seeded nat of two images."""
    for st in staged.scans:
        plan = st.scan.plan
        assert plan.structured is not None
        rng = np.random.default_rng(plan.n_blocks)
        nat = rng.integers(-32768, 32768, (2, plan.n_blocks, 64),
                           dtype=np.int16)
        general = copy.copy(plan)
        general.structured = None
        for branch, p in (("structured", plan), ("general", general)):
            maps = None if p.structured is not None else GeneralMaps(p, "cpu")
            got = assemble_nat(torch.from_numpy(nat), p, maps)
            for g, w in zip(got, _reference(plan, nat, branch, monkeypatch)):
                np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("comps,rows,stripes,ri", [
    (((2, 2, 0, 1), (1, 1, 0, 1), (1, 1, 0, 1)), 3, 4, 0),
    (((1, 1, 0, 0),), 5, 3, 0),
    (((1, 2, 0, 0), (1, 1, 0, 0), (1, 1, 0, 0)), 2, 5, 0),
    (((2, 2, 0, 0), (1, 1, 0, 0), (1, 1, 0, 0)), 2, 3, 7),
])
def test_stripe_carry_is_the_sum_of_earlier_stripes(comps, rows, stripes,
                                                    ri, monkeypatch):
    """An image of `stripes` x `rows` MCU rows cut into stripes: each
    stripe assembled with the carry `_dc_carry` gives it (the diff totals
    of every earlier stripe, `dc_totals`, summed in int64 with high bits),
    stacked, equals the reference's assembly of the whole image. Restart
    segments (ri > 0: 7 of the stripe's 14 MCUs, so that every segment lies
    inside a stripe, as the splitter requires) take no carry."""
    cols = 7
    whole = A1Plan(tuple((vs, hs, 0, 0) for vs, hs, _r, _c in comps),
                   rows * stripes, cols, ri)
    part = A1Plan(tuple((vs, hs, 0, 0) for vs, hs, _r, _c in comps), rows,
                  cols, ri)
    rng = np.random.default_rng(rows * stripes)
    nat = rng.integers(-32768, 32768, (2, whole.n_blocks, 64),
                       dtype=np.int16)
    ref = _reference(whole, nat, "structured", monkeypatch)
    pieces = torch.from_numpy(nat).split(part.n_blocks, 1)
    total = torch.full((2, part.ncomp), 2 ** 50, dtype=torch.int64)
    outs = []
    for piece in pieces:
        outs.append(assemble_nat(piece.contiguous(), part, None,
                                 (total - 2 ** 50).T))
        total = total + dc_totals(piece.contiguous(), part)
    for c in range(part.ncomp):
        got = torch.cat([o[c] for o in outs], 1)
        np.testing.assert_array_equal(got.numpy(), ref[c])


def test_unpack_delta_plain_on_a_merged_group_wire(monkeypatch):
    """A group's merged delta wire (tower_420 x 2 and three of the hetero
    sizes, the merge the port's `merge_scans` makes and the reference's
    `merge_image_packs_delta`): the port's (ab, base) against
    `unpack_delta_classes`' (ab >>> 3, meta, base) of every live chunk."""
    monkeypatch.setenv("JPEG_TPU_CLASS_COLLAPSE", "1")
    names = ["tower_420.jpg", "tower_420.jpg", "mixed_500x375.jpg",
             "mixed_333x500.jpg", "mixed_320x240.jpg"]
    refs = [reference_stage_host_bits(fixture(n)).scans[0][0] for n in names]
    packs = [pack_delta(s) for s in refs]
    nbs = [s.plan.n_blocks for s in refs]
    (words, dm, cnts), shapes = merge_image_packs_delta(packs, nbs)
    assert len(shapes) == 1
    port = merge_scans([jt.stage_host_bits(fixture(n)).scans[0]
                        for n in names])
    np.testing.assert_array_equal(port[0][1], dm)
    sb, meta, base = [np.asarray(x) for x in unpack_delta_classes(
        tuple(map(np.asarray, (words, dm, cnts))),
        tuple(s[:3] for s in shapes), sum(nbs))[0]]
    ab, got_base = (t.numpy() for t in unpack_delta(torch.from_numpy(dm)))
    n = int(cnts.sum())
    u = dm.view(np.uint32)
    budget = (u >> 4 & 31).astype(np.int32)
    live = budget > 0       # the images' terminators sort past the class
    assert live.sum() == n and (~live).sum() >= len(names)
    port_meta = (ab & 7) | ((u & 15) << 3).astype(np.int32) | budget << 7
    np.testing.assert_array_equal(ab[live] >> 3, sb[:n])
    np.testing.assert_array_equal(port_meta[live], meta[:n])
    np.testing.assert_array_equal(got_base[live], base[:n])
    assert got_base[-1] + budget[-1] == sum(nbs)


def test_dispatch_and_refusals():
    """CPU tensors take the plain versions; another device raises; a plan
    without the closed form needs its maps."""
    plan, nat, _carry = a1_case(A1_CASES[1])
    meta = torch.from_numpy(nat).to("meta")
    with pytest.raises(ValueError, match="no A1 implementation"):
        assemble_nat(meta, plan, GeneralMaps(plan, "cpu"))
    with pytest.raises(ValueError, match="GeneralMaps"):
        assemble_nat(torch.from_numpy(nat), plan)
    with pytest.raises(ValueError, match="no U1 implementation"):
        unpack_delta(torch.zeros(4, dtype=torch.int32, device="meta"))
    dm = torch.tensor([5 << 9 | 3 << 4 | 1, -1, 0], dtype=torch.int32)
    ab, base = unpack_delta(dm)
    assert ab.tolist() == [5, 5 + (0xFFFFFFFF >> 9), 5 + (0xFFFFFFFF >> 9)]
    assert base.tolist() == [0, 3, 34]
    assert all(torch.equal(a, b) for a, b in zip(unpack_delta(dm),
                                                 unpack_delta_plain(dm)))


def test_a1_constants_match_the_kernel_source():
    """The wrapper sizes A1's status buffer by its tile and packs its
    per-component fields as the kernel reads them."""
    src = (CSRC / "assemble.cu").read_text()
    assert int(re.search(r"constexpr int kRows = (\d+);", src)[1]) == A1_ROWS
    fields = int(re.search(r"constexpr int kCompMeta = (\d+);", src)[1])
    plan, _nat, _carry = a1_case(A1_CASES[0])
    layout = assemble._structured_layout(plan)
    assert len(layout.meta) == fields * plan.ncomp
    maps = GeneralMaps(plan, "cpu")
    assert len(maps.a1.meta) == fields * plan.ncomp
    assert len(maps.a1.ptrs) == 4 * plan.ncomp
    assert layout.rows == maps.a1.rows
    assert layout.data_tiles == maps.a1.data_tiles


def test_u1_constants_match_the_kernel_source():
    """The wrapper counts U1's tiles (and so whether a launch needs the
    status buffer, and how many words) by the kernel's tile."""
    src = (CSRC / "unpack_delta.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    per = int(re.search(r"constexpr int kPer = (\d+);", src)[1])
    assert threads * per == U1_TILE


def test_status_buffers_per_kernel_and_their_epochs(monkeypatch):
    """`_build.status_buffer`: a buffer per (kernel, device, stream), zeroed
    only when made; a new epoch every call, never 0; remade when it is
    outgrown or its epochs run out (U1's 30 bits, A1's 32)."""
    from jpeg_decoder_tpu_torch import _build

    monkeypatch.setattr(_build, "_status", {})
    dev = torch.device("cpu")
    u1, e1 = _build.status_buffer("unpack_delta", dev, 7, 10, 30)
    assert u1.numel() >= 11 and not u1.any() and e1 == 1
    u1[1:] = -1
    again, e2 = _build.status_buffer("unpack_delta", dev, 7, 10, 30)
    assert again is u1 and e2 == 2 and bool((u1[1:] == -1).all())
    a1, e3 = _build.status_buffer("assemble", dev, 7, 10, 32)
    other, e4 = _build.status_buffer("unpack_delta", dev, 8, 10, 30)
    assert a1 is not u1 and other is not u1 and e3 == e4 == 1
    big, e5 = _build.status_buffer("unpack_delta", dev, 7, 2 * u1.numel(),
                                   30)
    assert big is not u1 and big.numel() > 2 * u1.numel() and e5 == 1
    _build._status["unpack_delta", dev, 7][1] = (1 << 30) - 2
    last, e6 = _build.status_buffer("unpack_delta", dev, 7, 10, 30)
    assert last is big and e6 == (1 << 30) - 1
    fresh, e7 = _build.status_buffer("unpack_delta", dev, 7, 10, 30)
    assert fresh is not big and e7 == 1 and not fresh.any()
    _build._status["assemble", dev, 7][1] = (1 << 30) - 1
    assert _build.status_buffer("assemble", dev, 7, 10, 32) == (a1, 1 << 30)

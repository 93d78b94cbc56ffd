"""K1 module of the PyTorch port against the JAX package: delta unpack,
chunk Huffman decode and assembly (jpeg_decoder_tpu_torch/entropy/).

On the CPU `decode_chunks` runs the kernel's plain PyTorch version. The
reference decode is the JAX package's own CPU reference for its Pallas
kernel, the XLA lax.scan engine `decode_anchored_device` (Pallas interpret
mode takes minutes per case), plus the host oracle's stores.
Tolerance: bit-equal everywhere — the entropy stage is exact integer code.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_decoder_tpu.entropy.device_scan import (build_assembler_nat,
                                                  decode_anchored_device)
from jpeg_decoder_tpu.entropy.pallas_decode import (pack_delta,
                                                    unpack_delta_classes)
from jpeg_decoder_tpu_torch.entropy.assemble import (GeneralMaps,
                                                     assemble_general,
                                                     assemble_nat,
                                                     assemble_structured)
from jpeg_decoder_tpu_torch.entropy.chunk_decode import (S_MAX_LIMIT,
                                                         decode_chunks,
                                                         unpack_delta)
from jpeg_decoder_tpu_torch.models.stream import stage_host_bits
from jpeg_decoder_tpu_torch.params import scan_tables

from torch_inputs import ENTROPY_CASES, entropy_case, oracle_stores


def _port_nat(st, device="cpu"):
    words = torch.from_numpy(st.words).to(device)
    dm = torch.from_numpy(st.dm).to(device)
    ab, base = unpack_delta(dm)
    return decode_chunks(words, dm, ab, base, scan_tables(st.scan, device),
                         st.s_max, st.scan.plan.n_blocks)


def _nat_from_stores(plan, stores) -> np.ndarray:
    """Invert the reference assembly: raster stores with absolute DC ->
    stream-order nat with wrap16 DC differences per restart segment."""
    nat = np.zeros((plan.n_blocks, 64), np.int16)
    for c, store in enumerate(stores):
        grid = np.asarray(store).reshape(-1, 64)
        src = plan.raster_src[c]
        n_c = len(plan.stream_idx[c])
        rows = np.zeros((n_c, 64), np.int16)
        live = src < n_c
        rows[src[live]] = grid[live]
        dc = rows[:, 0].astype(np.int64)
        prev = np.concatenate([[0], dc[:-1]])
        first = plan.seg_first[c] == np.arange(n_c)
        rows[:, 0] = np.where(first, dc, dc - prev).astype(np.int16)
        nat[plan.stream_idx[c]] = rows
    return nat


@pytest.mark.parametrize("case", list(ENTROPY_CASES))
def test_nat_and_stores_bit_equal_to_xla_engine_and_oracle(case):
    data = entropy_case(case)
    staged = stage_host_bits(data)
    oracle = oracle_stores(data)
    for st in staged.scans:
        scan = st.scan
        # Color scans carry two table pairs (luma, chroma); gray one.
        assert len(scan.tab_maxcode) == (4 if scan.plan.ncomp == 3 else 2)
        nat = _port_nat(st)
        xla = [np.asarray(s).reshape(-1) for s in decode_anchored_device(scan)]
        np.testing.assert_array_equal(nat.numpy(),
                                      _nat_from_stores(scan.plan, xla))
        port = assemble_nat(nat, scan.plan)
        for pos, comp_i in st.kept:
            got = port[pos].numpy().reshape(-1)
            np.testing.assert_array_equal(got, xla[pos])
            np.testing.assert_array_equal(got, oracle[comp_i])


@pytest.mark.parametrize("collapse", ["1", "0"])
@pytest.mark.parametrize("case", ["420", "dri420", "gray"])
def test_delta_unpack_matches_unpack_delta_classes(case, collapse,
                                                   monkeypatch):
    """(ab & 7, slot0, budget, base) of every live chunk equal the
    reference's device unpack (slot0 and budget read off the wire word,
    ab and base from `unpack_delta`). With class collapse off the reference
    partitions chunks into span classes; the port keeps stream order, so
    the live entries are compared as sets keyed by their block base, and
    the multi-class wire must still decode to the oracle's stores."""
    monkeypatch.setenv("JPEG_TPU_CLASS_COLLAPSE", collapse)
    data = entropy_case(case)
    staged = stage_host_bits(data)
    st = staged.scans[0]
    (words, dm, cnts), shapes = pack_delta(st.scan)
    np.testing.assert_array_equal(dm, st.dm)
    if collapse == "0" and case == "420":
        assert len(shapes) > 1, "expected several span classes"
    ref = unpack_delta_classes(
        (jnp.asarray(words), jnp.asarray(dm), jnp.asarray(cnts)), shapes,
        st.scan.plan.n_blocks)
    ref_sb = np.concatenate([np.asarray(sb)[:c] for (sb, _m, _b), c
                             in zip(ref, cnts)])
    ref_meta = np.concatenate([np.asarray(m)[:c] for (_s, m, _b), c
                               in zip(ref, cnts)])
    ref_base = np.concatenate([np.asarray(b)[:c] for (_s, _m, b), c
                               in zip(ref, cnts)])

    ab, base = (t.numpy() for t in unpack_delta(torch.from_numpy(dm)))
    budget = (dm.view(np.uint32) >> 4 & 31).astype(np.int32)
    slot0 = (dm.view(np.uint32) & 15).astype(np.int32)
    n = int(cnts.sum())
    assert (budget[:n] > 0).all() and (budget[n:] == 0).all()
    port_meta = (ab & 7) | (slot0 << 3) | (budget << 7)
    order = np.argsort(ref_base, kind="stable")
    if len(shapes) == 1:
        np.testing.assert_array_equal(order, np.arange(n))
    np.testing.assert_array_equal(base[:n], ref_base[order])
    np.testing.assert_array_equal(ab[:n] >> 3, ref_sb[order])
    np.testing.assert_array_equal(port_meta[:n], ref_meta[order])

    stores = assemble_nat(_port_nat(st), st.scan.plan)
    oracle = oracle_stores(data)
    for pos, comp_i in st.kept:
        np.testing.assert_array_equal(stores[pos].numpy().reshape(-1),
                                      oracle[comp_i])


@pytest.mark.parametrize("branch", ["structured", "general"])
@pytest.mark.parametrize("case", ["444", "422", "dri420", "dri_gray"])
def test_assemblers_match_build_assembler_nat(case, branch, monkeypatch):
    """Random full-range int16 nat (wrap16 DC sums included) through both
    assembler branches, each against the reference's same branch."""
    st = stage_host_bits(entropy_case(case)).scans[0]
    plan = st.scan.plan
    assert plan.structured is not None
    rng = np.random.default_rng(len(case) * 7 + len(branch))
    nat = rng.integers(-32768, 32768, (plan.n_blocks, 64)).astype(np.int16)
    monkeypatch.setenv("JPEG_TPU_STRUCT_ASM",
                       "1" if branch == "structured" else "0")
    ref = build_assembler_nat(plan, flat_stores=False)(jnp.asarray(nat))
    if branch == "structured":
        port = assemble_structured(torch.from_numpy(nat), plan)
    else:
        port = assemble_general(torch.from_numpy(nat),
                                GeneralMaps(plan, "cpu"))
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


def test_decode_chunks_dispatch_and_checks():
    st = stage_host_bits(entropy_case("gray")).scans[0]
    words = torch.from_numpy(st.words)
    dm = torch.from_numpy(st.dm)
    ab, base = unpack_delta(dm)
    tables = scan_tables(st.scan, "cpu")
    n_blocks = st.scan.plan.n_blocks
    with pytest.raises(TypeError):
        decode_chunks(words.to(torch.int64), dm, ab, base, tables, st.s_max,
                      n_blocks)
    with pytest.raises(ValueError):
        decode_chunks(words, dm, ab[:-1], base, tables, st.s_max, n_blocks)
    with pytest.raises(ValueError):     # past 31 blocks x 64 symbols
        decode_chunks(words, dm, ab, base, tables, S_MAX_LIMIT + 1, n_blocks)
    meta = [t.to("meta") for t in (words, dm, ab, base)]
    meta_tables = scan_tables(st.scan, "meta")
    with pytest.raises(ValueError, match="no K1 implementation"):
        decode_chunks(*meta, meta_tables, st.s_max, n_blocks)

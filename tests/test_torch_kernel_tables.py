"""The host-side parts of the redesigned kernels K1 and K2, on the CPU.

K1's lookahead table (`params.lookahead_tables`): for every 16-bit window,
of every table row of every fixture's scans, of the transcoded tables of
the progressive and quirk streams (DC categories up to 16) and of the
three-table-pair stream (6 rows), an entry gives the maxcode chain's code
length and symbol, the bits the symbol uses with its magnitude and its
zigzag advance (1 for DC, r + 1, 16 for ZRL, 64 for EOB), and a window
without an entry has a code longer than the table's bits (the kernel then
walks the chain). Tolerance: equal.

K1's walk table (`params.walk_tables`): for the same windows, the first
symbol's bits and advance equal the chain's, and where an entry takes two
symbols, the second (decoded with the pair's AC row from the bits after the
first) fits the table's bits and the totals are the two symbols' sums.

K2's split-TF32 product (`ops.kernels.split_tf32_product`, the kernel's
arithmetic in torch: coefficients split exactly, the folded basis split
into two TF32 parts rounded to nearest, hi*hi + hi*lo + lo*hi in fp32) on
seeded int16 blocks and on every fixture's coefficient stores, at scales
8, 4, 2 and 1: within 1 of `dequant_idct_plain`, K2's contract (the two
round in different places, so a value next to a .5 boundary may land one
step apart).
"""

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu_torch import stage_host_bits
from jpeg_decoder_tpu_torch.host.decoder import Decoder
from jpeg_decoder_tpu_torch.ops.kernels import (dequant_idct_plain,
                                                split_tf32_product)
from jpeg_decoder_tpu_torch.params import (LUT_BITS, WALK_DOUBLE,
                                           chain_decode, folded_basis,
                                           idct_basis, lookahead_tables,
                                           quant_table, unpack_values,
                                           walk_tables)

from torch_inputs import FIXTURE_DIR, fixture, quirk_jpeg, three_table_pairs

FIXTURES = tuple(sorted(p.name for p in FIXTURE_DIR.glob("*.jpg")))
TABLE_CASES = {n: (lambda n=n: fixture(n)) for n in FIXTURES}
TABLE_CASES["quirk_jpeg"] = lambda: quirk_jpeg(4)
TABLE_CASES["three_table_pairs"] = \
    lambda: three_table_pairs(fixture("small_444.jpg"))


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_lookahead_table_matches_the_maxcode_chain(case):
    windows = np.arange(1 << 16, dtype=np.int64)
    for st in stage_host_bits(TABLE_CASES[case]()).scans:
        scan = st.scan
        lut = lookahead_tables(scan.tab_maxcode, scan.tab_delta,
                               scan.tab_values).astype(np.int64)
        values = unpack_values(scan.tab_values)
        assert lut.shape == (len(values), 1 << LUT_BITS)
        for row, (mc, dl, vals) in enumerate(zip(scan.tab_maxcode,
                                                 scan.tab_delta, values)):
            length, symbol = chain_decode(windows, mc, dl, vals)
            entry = lut[row][windows >> (16 - LUT_BITS)]
            hit = entry != 0
            np.testing.assert_array_equal((entry[hit] >> 8) & 31,
                                          length[hit])
            np.testing.assert_array_equal(entry[hit] & 0xFF, symbol[hit])
            r, s = symbol >> 4, symbol & 15
            mag = symbol if row % 2 == 0 else s
            dk = np.ones_like(symbol) if row % 2 == 0 else \
                np.where(s != 0, r + 1, np.where(r == 15, 16, 64))
            np.testing.assert_array_equal((entry[hit] >> 13) & 511,
                                          (length + mag)[hit])
            np.testing.assert_array_equal(entry[hit] >> 22, dk[hit])
            assert (length[~hit] > LUT_BITS).all()


def _steps(symbol, is_dc: bool):
    r, s = symbol >> 4, symbol & 15
    if is_dc:
        return symbol, np.ones_like(symbol)
    return s, np.where(s != 0, r + 1, np.where(r == 15, 16, 64))


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_walk_table_matches_two_chain_decodes(case):
    windows = np.arange(1 << 16, dtype=np.int64)
    for st in stage_host_bits(TABLE_CASES[case]()).scans:
        scan = st.scan
        walk = walk_tables(scan.tab_maxcode, scan.tab_delta,
                           scan.tab_values).astype(np.int64)
        values = unpack_values(scan.tab_values)
        for row in range(len(values)):
            ac = row + 1 if row % 2 == 0 else row
            length, symbol = chain_decode(windows, scan.tab_maxcode[row],
                                          scan.tab_delta[row], values[row])
            mag, dk = _steps(symbol, row % 2 == 0)
            entry = walk[row][windows >> (16 - LUT_BITS)]
            hit = entry != 0
            assert (length[~hit] > LUT_BITS).all()
            np.testing.assert_array_equal(entry[hit] & 511,
                                          (length + mag)[hit])
            np.testing.assert_array_equal((entry[hit] >> 9) & 127, dk[hit])
            two = hit & ((entry & WALK_DOUBLE) != 0)
            used1 = np.clip(length + mag, 0, 16)
            rest = (windows << used1) & 0xFFFF
            length2, symbol2 = chain_decode(rest, scan.tab_maxcode[ac],
                                            scan.tab_delta[ac], values[ac])
            mag2, dk2 = _steps(symbol2, False)
            assert (dk[two] < 64).all()
            assert (length + mag + length2 + mag2 <= LUT_BITS)[two].all()
            np.testing.assert_array_equal(
                (entry[two] >> 16) & 15, (length + mag + length2 + mag2)[two])
            np.testing.assert_array_equal((entry[two] >> 20) & 127,
                                          (dk + dk2)[two])


def _fixture_stores(name: str) -> list:
    d = Decoder(fixture(name), backend="numpy")
    d._decode_entropy_only()
    return [(d._pending_render[i][0].reshape(-1, 64), d._pending_render[i][1])
            for i in range(len(d.frame.components))]


def _seeded_stores() -> list:
    rng = np.random.default_rng(8)
    return [(rng.integers(-2048, 2048, (20000, 64)).astype(np.int16),
             rng.integers(1, 100, 64).astype(np.uint16)) for _ in range(3)]


@pytest.mark.parametrize("scale", [8, 4, 2, 1])
@pytest.mark.parametrize("source", ("seeded",) + FIXTURES)
def test_split_tf32_product_within_1_of_plain(source, scale):
    stores = _seeded_stores() if source == "seeded" else \
        _fixture_stores(source)
    basis = idct_basis(scale, "cpu")
    for coef_np, qt in stores:
        coef = torch.from_numpy(np.ascontiguousarray(coef_np))
        got = split_tf32_product(coef, folded_basis(qt, scale, "cpu"), scale)
        want = dequant_idct_plain(coef, quant_table(qt, "cpu"), basis, scale)
        assert got.shape == want.shape == (coef.shape[0], scale * scale)
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        assert int(diff.max()) <= 1

"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs a CUDA device and skips without one (the
`cuda` fixture decides at run time); on a machine with a card run

    python -m pytest tests/test_torch_cuda.py -q

Needs neither JAX nor PIL: the inputs are the committed fixtures.
Tolerances: K1 bit-equal (integer decode), also with 6 table rows on the
anchor wire, with an s_max cut and with blocks past the chunks' cover (the
kernel writes every row of `nat` itself, over memory that was not
zeroed); K2 |diff| <= 1 (its split-TF32 tensor-core product rounds in
other places than the plain fp32 matmul), also with three components in
one launch, and one launch per image on the fast path; decoded images
|diff| <= 3 against the CPU port (the K2 difference after color
conversion); K3 bit-equal (integer math); K4 bit-equal to K2 +
blocks_to_plane + color (the same split-TF32 product on the same folded
bases), also at bw past its 128-block tiles, bw 1, widths cut mid-block
and not a multiple of 16, and coefficients >= 2048 in some blocks (the
lo*hi product each warp may skip), and within 3 of its plain version (1
in the IDCT, times up to 1.772 through color); a store that does not start
16-byte aligned is rejected; the planar layouts
bit-equal to the interleaved output on the card, permuted; K3 also at odd
widths with pitches 8 mod 16 and bases 8 bytes off 16; L1 bit-equal to its
plain version (integer math), also at its 32-row band edges and with three
components in one launch, and one L1 launch for a 3-component SOF3
image; exact-precision, prefix and lossless decodes bit-equal to the CPU
port (integer math throughout). Batches: K2's segment table (more than 4
segments, per-image tables, more than 64 segments in two launches) and
K3's image axis give each image the bits of its own launch (SHA-256
equal; K2 within 1 of plain, K3 equal to plain), and
`decode_stream(batch_size=8)` gives every image of every layout,
precision and interchange bit-equal to batch_size=1, with K1 once per
group, K2 and K3 once per plan and L1 once per lossless group. The
pinned host-to-card path: every put lands with its values, dtype and
shape; the pool stays within its budget and depth; a buffer is not
refilled before its copy has run; a put returns before queued work ends.
The front end: `Decoder` bit-equal to the host decode at "exact" and
within 3 at "fast" with one K2 launch, lossless with one L1 launch per
component at predictors 6 and 7 and none at 1; the service equal to the
`Decoder`; a timed stream equal to an untimed one. The mesh, on slots of
the card: K1 bit-equal to its plain version on every stripe wire (first
blocks negative where a stripe starts inside a chunk, last chunks cut at
the stripe's end) of stripe_420.jpg at 8 stripes and large_420 at 4 and
8; `decode_striped` bit-equal to the host exact decode with one K1 launch
per stripe; mesh groups bit-equal to the meshless decode with K1 and K2
once per shard. Malformed streams: the fuzzer's device mode
(`tools/fuzz_torch.py`) over 36 sources, with no failure. E1 (the exact
tier's int32 IDCT): bit-equal to its plain version at every scale on
`adversarial_blocks` and on fixture stores, a 48-segment group with
per-image tables bit-equal to per-image launches in one launch, a store
off a 16-byte boundary refused, one launch for one exact large_420 decode
and one per stripe. T1 (the interleaved tail): bit-equal to its plain
version on the card and on the CPU over `T1_CASES` (every mode and
transform, scales 8/4/2/1, width-1 and height-1 chroma, groups of 1 and
3, interleaved and planar, and the edges of the kernel's 16 x 128 tiles),
on every fixture's stores through `reconstruct`, on a group of 16 whose
image slabs are not adjacent (each image the bits of its own launch), on
groups whose slabs start at an odd byte offset into an odd output row
pitch (the byte loads and the narrow stores), and on the stripes on slots
of the card against the CPU stripes (row0 off the tiles, padding
stripes); one launch per large_420 decode at fast and exact. A1 (the
assembly) bit-equal to its plain version on the card and on the CPU over
`A1_CASES` (padded grids, restart segments across its tiles, 36-tile
sequences, groups, carries with high bits set, general maps) and K1's nat
of every fixture through both branches, alone and as a group of 3 with a
carry; misaligned input, maps on another device and a carry of the wrong
shape refused without a launch. U1 (the delta unpack) bit-equal to its
plain version on seeded wires of one tile to 2^20 + 1 entries with every
bit pattern and on the fixtures' and groups' merged wires (tower_420
x16, large_420 x4 and x16); 1,000 launches in a row and across the end
of its epochs, two streams at once and U1 interleaved with A1 on one
stream, each on its own status buffer; one kernel a call and nothing
else (no fill); `decode_stream(batch_size=16)` of large_420 with one U1
over many tiles, every image bit-equal to its batch-1 decode. One A1 and
one U1 per large_420 decode and per group of 4, one A1 per stripe and no
U1 on the anchor wires of stripes. P1 (the prefix rebuild) bit-equal to
its plain version on seeded wires (duplicate, out-of-range and negative
indices, an empty list, block counts around its tiles), on every
fixture's prefix wire and the q100 fixture, and on a merged group of 16;
two launches a call (one without residuals); a large_420 prefix image is
P1, K2 and T1 and no other kernel; wrong dtypes, shapes and devices
refused without a launch. D1 (a stripe's DC totals) bit-equal to its
plain version on every fixture's plan for 1 and 3 images, 1,000 launches
in a row, once per stripe of large_420 at 4 and 8; K1 writing into the
rows of a larger tensor (`decode_chunks(out=)`). The bits, prefix and
lossless device halves (`_run_device`, `_run_group`) under
`torch.cuda.set_sync_debug_mode("error")`: nothing synchronises, the
bits route's calls there all graph replays. The compiled dispatch
(`models/graphs.py`): large_420 and a tower_420 group of 4 in every
layout at both precisions, the first call, three replays and the eager
body bit-equal, each replay counting the eager body's launches (5 at
large_420); outputs handed out unchanged by later replays of one graph
through two images with other tables; replays across the end of A1's and
U1's device epochs; a capture that fails raises, keeps no graph and does
not fall back. The hetero group (the six mixed sizes and two repeats: one
sweep graph, six part graphs) in four layout and precision pairs: the
first call, three replays and the eager body bit-equal, the eager body's
launches, a second composition through the same sweep graph and two part
graphs at other offsets. A spy on a wrapper skips the calls a capture
makes: they launch nothing.
"""

import time

import numpy as np
import pytest
import torch

import jpeg_decoder_tpu_torch as jt
from jpeg_decoder_tpu_torch.entropy.chunk_decode import (decode_chunks,
                                                         decode_chunks_plain,
                                                         unpack_delta)
from jpeg_decoder_tpu_torch.ops.kernels import (dequant_idct,
                                                dequant_idct_multi,
                                                dequant_idct_plain,
                                                fused_recon,
                                                fused_recon_plain, fused_tail,
                                                fused_tail_plain)
from jpeg_decoder_tpu_torch.params import DeviceParams

from jpeg_decoder_tpu_torch.ops.predictors import (lossless_recur,
                                                   lossless_recur_plain)

from torch_inputs import (A1_CASES, ODD_TAIL_LAYOUTS, P1_SHAPES,
                          SMALL_FIXTURES, T1_CASES, a1_case, p1_case,
                          whole_geometry,
                          T1_LAYOUTS, TAIL_CASES, adversarial_blocks,
                          fixture, odd_tail_case, oracle_stores, t1_args,
                          t1_geometry, t1_pixels, tail_planes,
                          three_table_pairs)

# The mixed sizes of one encoder: one hetero bits group.
MIXED_SIZES = ("mixed_500x375.jpg", "mixed_375x500.jpg", "mixed_500x333.jpg",
               "mixed_333x500.jpg", "mixed_448x448.jpg", "mixed_320x240.jpg")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("name", SMALL_FIXTURES + ("tower_420.jpg",))
def test_k1_kernel_bit_equal_to_plain(cuda, name):
    params = DeviceParams(cuda)
    before = jt.LAUNCHES["huffman_decode"]
    for st in jt.stage_host_bits(fixture(name)).scans:
        words = torch.from_numpy(st.words).to(cuda)
        dm = torch.from_numpy(st.dm).to(cuda)
        ab, base = unpack_delta(dm)
        args = (words, dm, ab, base, params.tables(st.scan), st.s_max,
                st.scan.plan.n_blocks)
        torch.testing.assert_close(decode_chunks(*args),
                                   decode_chunks_plain(*args), rtol=0, atol=0)
    assert jt.LAUNCHES["huffman_decode"] > before


@pytest.mark.parametrize("scale", [8, 4, 2, 1])
def test_k2_kernel_within_1_of_plain(cuda, scale):
    params = DeviceParams(cuda)
    rng = np.random.default_rng(scale)
    coef = torch.from_numpy(
        rng.integers(-1024, 1024, (3001, 64)).astype(np.int16)).to(cuda)
    q = params.qt(rng.integers(1, 100, 64).astype(np.uint16))
    args = (coef, q, params.basis(scale), scale)
    a = dequant_idct(*args).to(torch.int32)
    b = dequant_idct_plain(*args).to(torch.int32)
    assert a.shape == (3001, scale * scale)
    assert int((a - b).abs().max()) <= 1


def test_decode_stream_on_card_matches_cpu_port(cuda):
    data = [fixture(n) for n in SMALL_FIXTURES]
    jt.reset_launches()
    with jt.DeviceStreamDecoder(device="cuda", host_threads=2) as dec:
        gpu = dec.decode_stream(data)
    assert jt.LAUNCHES["huffman_decode"] == len(data)
    assert jt.LAUNCHES["dequant_idct"] == len(data)     # one per image
    with jt.DeviceStreamDecoder(device="cpu", host_threads=2) as dec:
        cpu = dec.decode_stream(data)
    for g, c in zip(gpu, cpu):
        assert g.is_cuda and g.dtype == torch.uint8
        d = (g.cpu().to(torch.int32) - c.to(torch.int32)).abs()
        assert int(d.max()) <= 3


def test_stores_on_card_bit_equal_to_oracle(cuda):
    from jpeg_decoder_tpu_torch.entropy.assemble import assemble_nat

    params = DeviceParams(cuda)
    data = fixture("small_dri.jpg")
    oracle = oracle_stores(data)
    for st in jt.stage_host_bits(data).scans:
        dm = torch.from_numpy(st.dm).to(cuda)
        ab, base = unpack_delta(dm)
        nat = decode_chunks(torch.from_numpy(st.words).to(cuda), dm, ab, base,
                            params.tables(st.scan), st.s_max,
                            st.scan.plan.n_blocks)
        stores = assemble_nat(nat, st.scan.plan)
        for pos, comp_i in st.kept:
            np.testing.assert_array_equal(
                stores[pos].cpu().numpy().reshape(-1), oracle[comp_i])


@pytest.mark.parametrize("name", TAIL_CASES)
def test_k3_kernel_bit_equal_to_plain(cuda, name):
    modes, transform, out_h, out_w, chroma = TAIL_CASES[name]
    planes = [torch.from_numpy(p).to(cuda) for p in tail_planes(name, 3)]
    before = jt.LAUNCHES["fused_tail"]
    got = fused_tail(planes, modes, chroma, transform, out_h, out_w)
    want = fused_tail_plain(planes, modes, chroma, transform, out_h, out_w)
    assert jt.LAUNCHES["fused_tail"] == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _k4_args(cuda, bh, bw, width, big, seed):
    """Seeded K4 arguments; `big` puts coefficients of magnitude 2048-4095
    in about one block in 40, so some warps need the lo*hi product and
    their neighbours do not, in K4's tiles and in K2's alike."""
    rng = np.random.default_rng(seed)
    stores = []
    for _ in range(3):
        s = rng.integers(-300, 300, (bh, bw, 64))
        if big:
            hot = rng.random((bh, bw)) < 1 / 40
            s[hot, :8] = rng.choice([-1, 1], (int(hot.sum()), 8)) \
                * rng.integers(2048, 4096, (int(hot.sum()), 8))
        stores.append(torch.from_numpy(s.astype(np.int16)).to(cuda))
    params = DeviceParams(cuda)
    q = torch.stack([params.qt(rng.integers(1, 60, 64).astype(np.uint16))
                     for _ in range(3)])
    return (*stores, q, params.basis(8), width)


@pytest.mark.parametrize("bh,bw,width,big", [
    (5, 7, 56, False), (3, 33, 259, False), (1, 1, 5, False),
    (4, 129, 1030, False), (2, 300, 2387, False), (9, 1, 8, False),
    (1, 256, 2048, False), (6, 70, 555, True), (3, 257, 2056, True)])
def test_k4_kernel_bit_equal_to_k2_path(cuda, bh, bw, width, big):
    """K4 against the decoder's K2 path: bit for bit."""
    args = _k4_args(cuda, bh, bw, width, big, bh * 100 + bw)
    before = jt.LAUNCHES["fused_recon"]
    got = fused_recon(*args)
    assert jt.LAUNCHES["fused_recon"] == before + 1
    assert tuple(got.shape) == (3, bh * 8, width)
    torch.testing.assert_close(got, fused_recon_plain(*args, k2=dequant_idct),
                               rtol=0, atol=0)
    d = got.to(torch.int32) - fused_recon_plain(
        *args, k2=dequant_idct_plain).to(torch.int32)
    assert int(d.abs().max()) <= 3


def test_k4_rejects_a_store_not_16_byte_aligned(cuda):
    y, cb, cr, q, basis, width = _k4_args(cuda, 2, 3, 24, False, 1)
    buf = torch.empty(y.numel() + 8, dtype=torch.int16, device=cuda)
    shifted = buf[4:4 + y.numel()].view(y.shape)      # 8 bytes off 16
    shifted.copy_(y)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 8
    before = jt.LAUNCHES["fused_recon"]
    with pytest.raises(ValueError, match="16-byte"):
        fused_recon(y, shifted, cr, q, basis, width)
    assert jt.LAUNCHES["fused_recon"] == before


@pytest.mark.parametrize("layout", ["planar", "planar-pallas"])
def test_planar_layouts_on_card_bit_equal_to_interleaved(cuda, layout):
    data = [fixture(n) for n in SMALL_FIXTURES]
    with jt.DeviceStreamDecoder(device="cuda", host_threads=2) as dec:
        interleaved = dec.decode_stream(data)
    before = jt.LAUNCHES["fused_tail"]
    with jt.DeviceStreamDecoder(device="cuda", host_threads=2,
                                layout=layout) as dec:
        planar = dec.decode_stream(data)
    for p, i in zip(planar, interleaved):
        want = i.permute(2, 0, 1) if i.dim() == 3 else i
        torch.testing.assert_close(p, want, rtol=0, atol=0)
    fused = jt.LAUNCHES["fused_tail"] - before
    assert fused == (0 if layout == "planar" else 4)    # not gray, not RGB


@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("predictor", range(1, 8))
def test_l1_kernel_bit_equal_to_plain(cuda, predictor, pt):
    rng = np.random.default_rng(predictor * 10 + pt)
    for shape in ((1, 67, 45), (3, 20, 9), (1, 1100, 3), (1, 1, 70)):
        d = rng.integers(-300, 300, shape)
        d[..., ::5] = rng.integers(0, 65536, d[..., ::5].shape)
        d = torch.from_numpy((d & 0xFFFF).astype(np.int32)).to(cuda)
        before = jt.LAUNCHES["lossless_recur"]
        got = lossless_recur(d, predictor, pt, 1 << (15 - pt))
        assert jt.LAUNCHES["lossless_recur"] == before + 1
        want = lossless_recur_plain(d, predictor, pt, 1 << (15 - pt))
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("h", [31, 32, 33, 65])
@pytest.mark.parametrize("predictor", [1, 3, 6, 7])
def test_l1_band_edges_and_three_components_in_one_launch(cuda, predictor,
                                                           h):
    rng = np.random.default_rng(predictor * 100 + h)
    for shape in ((1, h, 1), (3, h, 37), (3, h, 1)):
        d = rng.integers(0, 65536, shape).astype(np.int32)
        d = torch.from_numpy(d).to(cuda)
        before = jt.LAUNCHES["lossless_recur"]
        got = lossless_recur(d, predictor, 2, 1 << 13)
        assert jt.LAUNCHES["lossless_recur"] == before + 1
        torch.testing.assert_close(
            got, lossless_recur_plain(d, predictor, 2, 1 << 13), rtol=0,
            atol=0)


@pytest.mark.parametrize("predictor", [3, 6])
def test_three_component_sof3_launches_l1_once(cuda, predictor):
    from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

    samples = sof3_samples(70, 45, 3, 16, 0, seed=predictor)
    data = sof3_jpeg(samples, predictor, 0, 16)
    with jt.DeviceStreamDecoder(device="cuda", host_threads=1) as dec:
        staged = dec.stage(data)
        wires = dec._to_device(staged)
        torch.cuda.synchronize()
        jt.reset_launches()
        img = dec._run_device(staged, wires)
        torch.cuda.synchronize()
    assert jt.LAUNCHES["lossless_recur"] == 1
    np.testing.assert_array_equal(img.cpu().numpy(), samples)


@pytest.mark.parametrize("offset", [0, 8])
@pytest.mark.parametrize("layout", sorted(ODD_TAIL_LAYOUTS))
def test_k3_odd_widths_and_8_aligned_pitches(cuda, layout, offset):
    """Pitches 8 mod 16 (offset 0) or bases 8 bytes off 16 (offset 8)."""
    rng = np.random.default_rng(len(layout) + offset)
    for out_w in range(1, 40, 2):
        for out_h in (1, 2, 5):
            args = odd_tail_case(layout, out_h, out_w, offset, rng, cuda)
            torch.testing.assert_close(fused_tail(*args),
                                       fused_tail_plain(*args), rtol=0,
                                       atol=0)


@pytest.mark.parametrize("name", ["small_444.jpg", "tower_420.jpg"])
def test_k1_six_table_rows_on_the_anchor_wire(cuda, name):
    params = DeviceParams(cuda)
    data = three_table_pairs(fixture(name))
    oracle = oracle_stores(data)
    (st,) = jt.stage_host_bits(data).scans
    assert st.wire == "anchor" and params.tables(st.scan).n_tab == 6
    from jpeg_decoder_tpu_torch.entropy.assemble import assemble_nat

    args = tuple(torch.from_numpy(a).to(cuda)
                 for a in (st.words, st.dm, st.ab, st.base)) + (
        params.tables(st.scan), st.s_max, st.scan.plan.n_blocks)
    nat = decode_chunks(*args)
    torch.testing.assert_close(nat, decode_chunks_plain(*args), rtol=0,
                               atol=0)
    stores = assemble_nat(nat, st.scan.plan)
    for pos, comp_i in st.kept:
        np.testing.assert_array_equal(stores[pos].cpu().numpy().reshape(-1),
                                      oracle[comp_i])


def test_other_paths_on_card_bit_equal_to_cpu_port(cuda):
    """Exact precision (bits and prefix), progressive, the anchor wire and
    lossless: integer math end to end, so the card equals the CPU."""
    from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

    base = fixture("small_dri.jpg")
    data = [base, fixture("small_422_progressive.jpg"),
            three_table_pairs(base),
            sof3_jpeg(sof3_samples(70, 90, 1, 16, 0, seed=5), 6, 0, 16),
            sof3_jpeg(sof3_samples(30, 20, 3, 12, 0, seed=6), 3, 0, 12)]
    for interchange in ("bits", "prefix"):
        outs = {}
        for dev in ("cuda", "cpu"):
            with jt.DeviceStreamDecoder(device=dev, host_threads=2,
                                        precision="exact",
                                        interchange=interchange) as dec:
                outs[dev] = dec.decode_stream(data)
        for g, c in zip(outs["cuda"], outs["cpu"]):
            assert g.is_cuda
            torch.testing.assert_close(g.cpu(), c, rtol=0, atol=0)


def _k1_args(cuda, name: str):
    params = DeviceParams(cuda)
    (st,) = jt.stage_host_bits(fixture(name)).scans
    dm = torch.from_numpy(st.dm).to(cuda)
    ab, base = unpack_delta(dm)
    return (torch.from_numpy(st.words).to(cuda), dm, ab, base,
            params.tables(st.scan), st.s_max, st.scan.plan.n_blocks)


def _dirty_cache(cuda, nbytes: int) -> None:
    """Leave nonzero bytes in the caching allocator's free blocks, so that
    a kernel that skipped a row of its `torch.empty` output shows it."""
    torch.full((nbytes + 4096,), 0x55, dtype=torch.uint8, device=cuda)
    torch.cuda.synchronize()


@pytest.mark.parametrize("s_max", [1, 7, 40])
def test_k1_s_max_cut_leaves_unreached_blocks_zero(cuda, s_max):
    words, dm, ab, base, tables, _s_max, n_blocks = _k1_args(
        cuda, "tower_420.jpg")
    args = (words, dm, ab, base, tables, s_max, n_blocks)
    _dirty_cache(cuda, n_blocks * 128)
    got = decode_chunks(*args)
    want = decode_chunks_plain(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int((want == 0).all(dim=1).sum()) > 0     # unreached blocks


@pytest.mark.parametrize("extra", [1, 33, 500])
def test_k1_blocks_beyond_the_chunks_cover_are_zero(cuda, extra):
    words, dm, ab, base, tables, s_max, n_blocks = _k1_args(
        cuda, "small_444.jpg")
    args = (words, dm, ab, base, tables, s_max, n_blocks + extra)
    _dirty_cache(cuda, (n_blocks + extra) * 128)
    got = decode_chunks(*args)
    torch.testing.assert_close(got, decode_chunks_plain(*args), rtol=0,
                               atol=0)
    assert not got[n_blocks:].any()


@pytest.mark.parametrize("scale", [8, 4, 2, 1])
def test_k2_three_components_in_one_launch_within_1_of_plain(cuda, scale):
    params = DeviceParams(cuda)
    rng = np.random.default_rng(40 + scale)
    coefs, qs = [], []
    for n, lim in ((3001, 1024), (700, 4096), (129, 300)):
        c = rng.integers(-lim, lim, (n, 64)).astype(np.int16)
        coefs.append(torch.from_numpy(c).to(cuda))
        qs.append(params.qt(rng.integers(1, 100, 64).astype(np.uint16)))
    bases = [params.basis(scale)] * 3
    before = jt.LAUNCHES["dequant_idct"]
    got = dequant_idct_multi(coefs, qs, bases, [scale] * 3)
    assert jt.LAUNCHES["dequant_idct"] == before + 1
    for g, c, q in zip(got, coefs, qs):
        assert g.shape == (c.shape[0], scale * scale)
        want = dequant_idct_plain(c, q, params.basis(scale), scale)
        assert int((g.to(torch.int32) - want.to(torch.int32)).abs().max()) \
            <= 1


def test_k2_launches_once_per_image_on_the_fast_path(cuda):
    data = [fixture(n) for n in ("tower_420.jpg", "small_cmyk_420.jpg",
                                 "small_gray.jpg")]
    with jt.DeviceStreamDecoder(host_threads=1) as dec:
        for d in data:
            staged = dec.stage(d)
            wires = dec._to_device(staged)
            torch.cuda.synchronize()
            jt.reset_launches()
            dec._run_device(staged, wires)
            assert jt.LAUNCHES["dequant_idct"] == 1, len(staged.qts)


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("n,ncomp,scale", [
    (7, 3, 8), (7, 3, 4), (5, 3, 2), (5, 3, 1), (18, 4, 8)])
def test_k2_segment_table_bit_equal_to_per_image_launches(cuda, n, ncomp,
                                                          scale):
    """A group of n images with their own tables (two neighbours share
    theirs, so the wrapper merges them), coefficients >= 2048 in some
    blocks: one launch per 64 segments, each image's pixels those of its
    own launch (SHA-256 equal), within 1 of plain."""
    from jpeg_decoder_tpu_torch.ops.kernels import (MAX_SEGMENTS,
                                                    dequant_idct_batch)

    params = DeviceParams(cuda)
    rng = np.random.default_rng(n * 10 + scale)
    blocks = (301, 37, 37, 300)[:ncomp]
    coefs = []
    for b in blocks:
        c = rng.integers(-300, 300, (n, b, 64))
        hot = rng.random((n, b)) < 1 / 40
        c[hot, :8] = rng.integers(2048, 4096, (int(hot.sum()), 8))
        coefs.append(torch.from_numpy(c.astype(np.int16)).to(cuda))
    tables = [[rng.integers(1, 60, 64).astype(np.uint16) for _ in blocks]
              for _ in range(n)]
    tables[2] = tables[1]
    qs = [[params.qt(tables[i][c]) for i in range(n)] for c in range(ncomp)]
    folded = [[params.folded(tables[i][c], scale) for i in range(n)]
              for c in range(ncomp)]
    bases = [params.basis(scale)] * ncomp
    before = jt.LAUNCHES["dequant_idct"]
    got = dequant_idct_batch(coefs, qs, bases, [scale] * ncomp, folded)
    segs = n * ncomp - ncomp             # images 1 and 2 share a segment
    assert jt.LAUNCHES["dequant_idct"] - before \
        == -(-segs // MAX_SEGMENTS)
    for i in range(n):
        alone = dequant_idct_multi(
            [c[i] for c in coefs], [q[i] for q in qs], bases,
            [scale] * ncomp, [f[i] for f in folded])
        assert _digest(g[i] for g in got) == _digest(alone)
        for g, c, q in zip(got, coefs, qs):
            want = dequant_idct_plain(c[i], q[i], params.basis(scale), scale)
            assert int((g[i].to(torch.int32) - want.to(torch.int32)).abs()
                       .max()) <= 1


@pytest.mark.parametrize("name", sorted(TAIL_CASES))
def test_k3_image_axis_bit_equal_to_per_image_launches(cuda, name):
    modes, transform, out_h, out_w, chroma = TAIL_CASES[name]
    per_image = [[torch.from_numpy(p).to(cuda) for p in tail_planes(name, s)]
                 for s in range(5)]
    stacked = [torch.stack(ps) for ps in zip(*per_image)]
    before = jt.LAUNCHES["fused_tail"]
    got = fused_tail(stacked, modes, chroma, transform, out_h, out_w)
    assert jt.LAUNCHES["fused_tail"] == before + 1
    alone = [fused_tail(p, modes, chroma, transform, out_h, out_w)
             for p in per_image]
    assert _digest(got) == _digest(alone)
    torch.testing.assert_close(
        got, fused_tail_plain(stacked, modes, chroma, transform, out_h,
                              out_w), rtol=0, atol=0)


@pytest.mark.parametrize("interchange", ["bits", "prefix"])
@pytest.mark.parametrize("precision", ["fast", "exact"])
@pytest.mark.parametrize("layout", ["interleaved", "planar",
                                    "planar-pallas"])
def test_batched_stream_on_card_bit_equal_to_batch_1(cuda, layout, precision,
                                                     interchange):
    """Same-key groups, a mixed-size group and a lossless group; K1, K2 and
    K3 once per group (K2 and K3 once per plan of a mixed group), L1 once
    for the predictor-6 group."""
    from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

    mixed = ["mixed_500x375.jpg", "mixed_375x500.jpg", "mixed_320x240.jpg"]
    stream = ([fixture("small_dri.jpg")] * 3 + [fixture(n) for n in mixed]
              + [sof3_jpeg(sof3_samples(40, 30, 3, 16, 0, seed=s), 6, 0, 16)
                 for s in range(3)])
    kw = {"layout": layout, "precision": precision,
          "interchange": interchange}
    with jt.DeviceStreamDecoder(host_threads=2, **kw) as dec:
        single = dec.decode_stream(stream)
        torch.cuda.synchronize()
        jt.reset_launches()
        batched = dec.decode_stream(stream, batch_size=8)
        torch.cuda.synchronize()
    for a, b in zip(batched, single):
        assert a.is_cuda and a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # bits: one sweep for all six JPEGs (one hetero key), then one
    # reconstruction per plan; prefix: small_dri's group and three of one.
    plans = 1 + len(mixed)
    assert jt.LAUNCHES["huffman_decode"] == (interchange == "bits")
    assert jt.LAUNCHES["lossless_recur"] == 1
    if precision == "fast" or layout == "planar-pallas":
        assert jt.LAUNCHES["dequant_idct"] == plans
    assert jt.LAUNCHES["fused_tail"] == (
        plans if layout == "planar-pallas" else 0)


# The pinned host-to-card path, the front end and the service on the card.

def test_pinned_put_values_dtypes_and_bounds(cuda):
    """Puts of one to four arrays of the dtypes the stream ships, many
    sizes, through a small pool: each array lands with its own values,
    dtype and shape; the pool never holds more than its budget nor more
    than `depth` buffers a class."""
    from jpeg_decoder_tpu_torch.transfer import PinnedPool

    pool = PinnedPool(cuda, depth=2, budget=1 << 20)
    rng = np.random.default_rng(80)
    sent, got = [], []
    for i in range(120):
        arrays = []
        for j in range(1 + i % 4):
            dtype = (np.int16, np.int32, np.int8, np.uint8)[(i + j) % 4]
            n = int(rng.integers(0, 30_000 // np.dtype(dtype).itemsize))
            arrays.append(rng.integers(-100, 100, n).astype(dtype)
                          .reshape(-1, 1))
        sent += arrays
        got += pool.put(arrays)
        assert pool.bytes <= 1 << 20
        assert all(v <= 2 for v in pool._held.values())
    torch.cuda.synchronize()
    for a, t in zip(sent, got):
        assert t.is_cuda and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.cpu().numpy(), a)
    assert pool.peak_bytes <= 1 << 20 and pool.copied_bytes == sum(
        a.nbytes for a in sent)


def test_pinned_buffer_waits_for_its_copy(cuda):
    """With one buffer per class, a second put of the same class while the
    first copy still waits behind a long kernel must not overwrite it."""
    from jpeg_decoder_tpu_torch.transfer import PinnedPool

    pool = PinnedPool(cuda, depth=1, budget=1 << 20)
    a = np.full(50_000, 7, np.int16)
    b = np.full(50_000, -3, np.int16)
    torch.cuda._sleep(200_000_000)          # ~0.1 s of the card's clock
    (first,) = pool.put((a,))
    (second,) = pool.put((b,))              # same class: waits for `first`
    torch.cuda.synchronize()
    assert int(pool._held[1 << 17]) == 1
    assert bool((first == 7).all()) and bool((second == -3).all())


def test_pinned_put_does_not_wait_for_the_card(cuda):
    """The copy is enqueued behind queued work: put returns before it."""
    from jpeg_decoder_tpu_torch.transfer import PinnedPool

    pool = PinnedPool(cuda)
    a = np.arange(1 << 18, dtype=np.int32)
    pool.put((a,))                          # allocate and register first
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)        # ~0.5 s of the card's clock
    t0 = time.perf_counter()
    (out,) = pool.put((a,))
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    assert enqueue < 0.1
    np.testing.assert_array_equal(out.cpu().numpy(), a)


@pytest.mark.parametrize("name", SMALL_FIXTURES
                         + ("small_422_progressive.jpg",))
def test_decoder_on_card_equals_host(cuda, name):
    from jpeg_decoder_tpu_torch.host.decoder import Decoder as HostDecoder

    data = fixture(name)
    want = HostDecoder(data).decode()
    assert jt.Decoder(data).decode() == want
    before = jt.LAUNCHES["dequant_idct"]
    fast = np.frombuffer(jt.Decoder(data, precision="fast").decode(),
                         np.uint8)
    assert jt.LAUNCHES["dequant_idct"] == before + 1
    assert int(np.abs(fast.astype(np.int16)
                      - np.frombuffer(want, np.uint8)).max()) <= 3


def test_decoder_lossless_on_card_one_l1_per_component(cuda):
    from jpeg_decoder_tpu_torch.host.decoder import Decoder as HostDecoder
    from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

    for predictor, ncomp, want in ((6, 3, 3), (1, 1, 0), (7, 1, 1)):
        data = sof3_jpeg(sof3_samples(70, 45, ncomp, 16, 0, seed=predictor),
                         predictor, 0, 16)
        before = jt.LAUNCHES["lossless_recur"]
        assert jt.Decoder(data).decode() == HostDecoder(data).decode()
        assert jt.LAUNCHES["lossless_recur"] == before + want


def test_service_on_card_equals_decoder(cuda):
    names = SMALL_FIXTURES + ("tower_420.jpg",)
    out = jt.BatchDecodeService(host_threads=2).decode_all(
        [fixture(n) for n in names])
    for name, img in zip(names, out):
        assert img.tobytes() == jt.Decoder(fixture(name)).decode()


def test_stream_with_timer_on_card_unchanged(cuda):
    stream = [fixture("tower_420.jpg")] * 12 + [fixture("small_444.jpg")] * 3
    timer = jt.StageTimer()
    with jt.DeviceStreamDecoder(host_threads=2, timer=timer) as dec:
        timed = dec.decode_stream(stream, batch_size=4)
    with jt.DeviceStreamDecoder(host_threads=2) as dec:
        plain = dec.decode_stream(stream, batch_size=4)
    assert all(torch.equal(a, b) for a, b in zip(timed, plain))
    assert {"host_stage", "h2d_submit", "device_dispatch"} <= set(
        timer.counts)


def test_link_probe_on_card(cuda):
    from jpeg_decoder_tpu_torch.utils import link

    assert link.probe() > 0


@pytest.mark.parametrize("name,n", [("stripe_420.jpg", 8),
                                    ("large_420.jpg", 4),
                                    ("large_420.jpg", 8)])
def test_k1_bit_equal_to_plain_on_every_stripe_wire(cuda, name, n):
    from jpeg_decoder_tpu_torch.parallel.stripe_bits import (
        split_anchored_stripes, stripe_wire)

    params = DeviceParams(cuda)
    scan = jt.stage_host_bits(fixture(name)).scans[0].scan
    split = split_anchored_stripes(scan, n)
    negative = 0
    for d in range(n):
        arrays, s_max = stripe_wire(split, d)
        args = tuple(torch.from_numpy(a).to(cuda) for a in arrays) + (
            params.tables(scan), s_max, split.n_blocks_local)
        torch.testing.assert_close(decode_chunks(*args),
                                   decode_chunks_plain(*args), rtol=0,
                                   atol=0)
        negative += int(len(arrays[3]) > 0 and arrays[3][0] < 0)
    if name == "stripe_420.jpg":
        assert negative >= 4


@pytest.mark.parametrize("n", [4, 8])
def test_decode_striped_on_card_slots(cuda, n):
    from jpeg_decoder_tpu_torch.host.decoder import Decoder as HostDecoder
    from jpeg_decoder_tpu_torch.parallel import make_mesh

    data = fixture("tower_420.jpg")
    mesh = make_mesh({"stripe": n}, ["cuda:0"] * n)
    jt.reset_launches()
    with jt.DeviceStreamDecoder(mesh=mesh, host_threads=1) as dec:
        img = dec.decode_striped(data)
    torch.cuda.synchronize()
    assert jt.LAUNCHES["huffman_decode"] == n and img.is_cuda
    assert jt.LAUNCHES["idct_exact"] == n
    gold = HostDecoder(data, backend="numpy", precision="exact")
    assert np.array_equal(img.cpu().numpy(), gold.decode_array())


@pytest.mark.parametrize("interchange", ["bits", "prefix"])
def test_mesh_groups_on_card_slots(cuda, interchange):
    from jpeg_decoder_tpu_torch.parallel import make_mesh

    stream = [fixture("tower_420.jpg")] * 8 + [fixture("small_444.jpg")] * 3
    with jt.DeviceStreamDecoder(host_threads=2,
                                interchange=interchange) as dec:
        want = dec.decode_stream(stream)
    mesh = make_mesh({"data": 4}, ["cuda:0"] * 4)
    jt.reset_launches()
    with jt.DeviceStreamDecoder(mesh=mesh, host_threads=2,
                                interchange=interchange) as dec:
        got = dec.decode_stream(stream, batch_size=8)
    torch.cuda.synchronize()
    # tower_420 x 8: 4 shards of 2; small_444 x 3 (bucket 4): 3 shards of 1.
    assert jt.LAUNCHES["dequant_idct"] == 7
    assert jt.LAUNCHES["huffman_decode"] == (7 if interchange == "bits"
                                             else 0)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)


def test_device_fuzz_on_card(cuda, tmp_path):
    """Malformed streams on the card (`tools/fuzz_torch.py`'s device mode):
    every check against the host oracle holds, K1 is bit-equal to its
    plain version on every staged scan, and K3 and L1 to theirs."""
    from tools import fuzz_torch

    res = fuzz_torch.run_device(36, 5, out=str(tmp_path), device="cuda",
                                log=lambda line: None)
    assert res["failures"] == 0
    assert res["k1_vs_plain_checked"] == res["k1_scans_checked"] > 0
    assert res["launches"]["huffman_decode"] >= res["k1_scans_checked"]
    assert res["k3_checked"] > 0 and res["l1_checked"] > 0


def _e1_plain(coef, q, scale):
    from jpeg_decoder_tpu_torch.ops.idct import dequantize_and_idct_blocks

    return dequantize_and_idct_blocks(coef, q, scale).reshape(
        coef.shape[0], scale * scale)


@pytest.mark.parametrize("source", ["adversarial", "fixtures"])
@pytest.mark.parametrize("scale", [8, 4, 2, 1])
def test_e1_kernel_bit_equal_to_plain(cuda, scale, source):
    from jpeg_decoder_tpu_torch.host.decoder import Decoder as HostDecoder
    from jpeg_decoder_tpu_torch.ops.kernels import idct_exact_batch

    params = DeviceParams(cuda)
    if source == "adversarial":
        cases = [adversarial_blocks(seed, 5000) for seed in (0, 1)]
    else:
        cases = []
        for name in SMALL_FIXTURES + ("tower_420.jpg",):
            d = HostDecoder(fixture(name), backend="numpy")
            d._decode_entropy_only()
            cases += [(store.reshape(-1, 64), qt)
                      for store, qt in d._pending_render.values()]
    before = jt.LAUNCHES["idct_exact"]
    for coef_np, qt in cases:
        coef = torch.from_numpy(np.ascontiguousarray(coef_np)).to(cuda)
        q = params.qt_exact(qt)
        got = idct_exact_batch([coef[None]], [[q]], [scale])[0][0]
        assert torch.equal(got, _e1_plain(coef, q, scale))
        assert torch.equal(got.cpu(), _e1_plain(coef.cpu(), q.cpu(), scale))
    assert jt.LAUNCHES["idct_exact"] - before == len(cases)


def test_e1_segment_table_bit_equal_to_per_image_launches(cuda):
    """16 images x 3 components with per-image 16-bit tables: 48 segments
    in one launch, each image's pixels those of its own launch and of the
    plain version."""
    from jpeg_decoder_tpu_torch.ops.kernels import idct_exact_batch

    params = DeviceParams(cuda)
    rng = np.random.default_rng(48)
    n, scales = 16, [8, 4, 2]
    coefs = [torch.from_numpy(rng.integers(-32768, 32768, (n, b, 64))
                              .astype(np.int16)).to(cuda)
             for b in (301, 77, 77)]
    qts = [[params.qt_exact(rng.integers(1, 65536, 64).astype(np.uint16))
            for _ in range(n)] for _ in coefs]
    before = jt.LAUNCHES["idct_exact"]
    got = idct_exact_batch(coefs, qts, scales)
    assert jt.LAUNCHES["idct_exact"] - before == 1
    for i in range(n):
        alone = idct_exact_batch([c[i:i + 1] for c in coefs],
                                 [[q[i]] for q in qts], scales)
        assert _digest(g[i] for g in got) == _digest(a[0] for a in alone)
        for g, c, q, s in zip(got, coefs, qts, scales):
            assert torch.equal(g[i], _e1_plain(c[i], q[i], s))


def test_e1_rejects_a_store_not_16_byte_aligned(cuda):
    from jpeg_decoder_tpu_torch.ops.kernels import idct_exact_batch

    q = DeviceParams(cuda).qt_exact(np.ones(64, np.uint16))
    odd = torch.zeros(2 * 64 + 4, dtype=torch.int16, device=cuda)[4:]
    before = jt.LAUNCHES["idct_exact"]
    with pytest.raises(ValueError, match="16-byte"):
        idct_exact_batch([odd.view(1, 2, 64)], [[q]], [8])
    assert jt.LAUNCHES["idct_exact"] == before


def test_e1_launches_once_for_an_exact_large_420(cuda):
    with jt.DeviceStreamDecoder(host_threads=1, precision="exact") as dec:
        staged = dec.stage(fixture("large_420.jpg"))
        wires = dec._to_device(staged)
        torch.cuda.synchronize()
        jt.reset_launches()
        img = dec._run_device(staged, wires)
        torch.cuda.synchronize()
    assert jt.LAUNCHES["idct_exact"] == 1
    assert jt.LAUNCHES["dequant_idct"] == 0
    assert img.is_cuda


@pytest.mark.parametrize("case", T1_CASES,
                         ids=["-".join(map(str, c)) for c in T1_CASES])
def test_t1_kernel_bit_equal_to_plain(cuda, case):
    from jpeg_decoder_tpu_torch.ops.kernels import (interleaved_tail,
                                                    interleaved_tail_plain)

    layout, transform, h, w, scale, images = case
    geometry = t1_geometry(layout, h, w, scale, transform)
    pixels = t1_pixels(geometry, images, 100 * h + w, cuda)
    args = t1_args(geometry)
    for planar in (False, True):
        before = jt.LAUNCHES["interleaved_tail"]
        got = interleaved_tail(pixels, *args, planar=planar)
        assert jt.LAUNCHES["interleaved_tail"] - before == 1
        assert torch.equal(got, interleaved_tail_plain(pixels, *args,
                                                       planar=planar))
        assert torch.equal(got.cpu(), interleaved_tail_plain(
            [p.cpu() for p in pixels], *args, planar=planar))


@pytest.mark.parametrize("precision", ["fast", "exact"])
@pytest.mark.parametrize("name", SMALL_FIXTURES + ("tower_420.jpg",))
def test_t1_reconstruct_on_card_equals_cpu(cuda, name, precision):
    """`reconstruct` on the card (K2 or E1, then T1) against the CPU port
    on the same stores: bit-equal at exact, within 1 of K2 at fast
    (the K2 difference through color: within 3)."""
    import dataclasses

    from jpeg_decoder_tpu_torch.host.decoder import Decoder as HostDecoder
    from jpeg_decoder_tpu_torch.ops.pipeline import reconstruct

    geometry = dataclasses.replace(jt.stage_host_bits(fixture(name)).geometry,
                                   precision=precision)
    d = HostDecoder(fixture(name), backend="numpy")
    d._decode_entropy_only()
    renders = [d._pending_render[i] for i in range(len(d._pending_render))]
    stores = [torch.from_numpy(s.reshape(1, -1, 64)) for s, _q in renders]
    qts = [tuple(q for _s, q in renders)]
    before = jt.LAUNCHES["interleaved_tail"]
    got = reconstruct(geometry, [s.to(cuda) for s in stores], qts,
                      DeviceParams(cuda))
    assert jt.LAUNCHES["interleaved_tail"] - before == 1
    want = reconstruct(geometry, stores, qts,
                       DeviceParams(torch.device("cpu")))
    diff = (got.cpu().to(torch.int32) - want.to(torch.int32)).abs().max()
    assert int(diff) <= (0 if precision == "exact" else 3)


def test_t1_group_of_16_bit_equal_to_per_image_launches(cuda):
    """16 images in one launch, each image's slab inside a wider buffer
    (the image stride is not n_c * s * s): each image the bits of its own
    launch and of the plain version."""
    from jpeg_decoder_tpu_torch.ops.kernels import (interleaved_tail,
                                                    interleaved_tail_plain)

    geometry = t1_geometry("420", 512, 512, 8, "YCBCR")
    wide = t1_pixels(geometry, 16, 16, cuda)
    pixels = [torch.cat([p, p[:, :7]], dim=1)[:, :p.shape[1]] for p in wide]
    assert pixels[0].stride(0) != pixels[0][0].numel()
    args = t1_args(geometry)
    before = jt.LAUNCHES["interleaved_tail"]
    got = interleaved_tail(pixels, *args)
    assert jt.LAUNCHES["interleaved_tail"] - before == 1
    assert torch.equal(got, interleaved_tail_plain(pixels, *args))
    for i in range(16):
        alone = interleaved_tail([p[i:i + 1] for p in pixels], *args)
        assert _digest([got[i]]) == _digest([alone[0]])


@pytest.mark.parametrize("layout,transform", [
    ("420", "YCBCR"), ("422", "YCBCR"), ("444", "YCBCR"), ("gray", None),
    ("mixed4", "YCCK"), ("440", "RGB")])
@pytest.mark.parametrize("scale", [8, 4, 2, 1])
def test_t1_odd_slabs_and_pitches_bit_equal_to_plain(cuda, layout, transform,
                                                     scale):
    """Three images whose slabs start 3 bytes into a buffer (the kernel's
    single-byte loads) into an output 145 columns wide at scale 8 (73, 37
    and 19 at 4, 2 and 1; gray crops 152, 76, 38, 19): no row pitch is a
    multiple of 16, so the kernel takes its 4-byte and single-byte stores.
    Interleaved and planar, bit-equal to the plain version, one launch
    each."""
    from jpeg_decoder_tpu_torch.ops.kernels import (interleaved_tail,
                                                    interleaved_tail_plain)

    geometry = t1_geometry(layout, 37, 145, scale, transform)
    odd = []
    for p in t1_pixels(geometry, 3, scale, cuda):
        flat = torch.zeros(p.numel() + 16, dtype=torch.uint8, device=cuda)
        odd.append(flat[3:3 + p.numel()].view(p.shape))
        odd[-1].copy_(p)
    assert all(p.data_ptr() % 2 for p in odd)
    args = t1_args(geometry)
    for planar in (False, True):
        before = jt.LAUNCHES["interleaved_tail"]
        got = interleaved_tail(odd, *args, planar=planar)
        assert jt.LAUNCHES["interleaved_tail"] - before == 1
        assert got.stride(-2 if planar or got.dim() == 3 else -3) % 16
        assert torch.equal(got, interleaved_tail_plain(odd, *args,
                                                       planar=planar))


@pytest.mark.parametrize("case", [("420", "YCBCR", 100, 90, 4),
                                  ("420", "YCBCR", 100, 90, 8),
                                  ("440", "YCBCR", 72, 37, 4),
                                  ("g23", "YCBCR", 100, 41, 4),
                                  ("mixed4", "YCCK", 50, 27, 4),
                                  ("422", "YCBCR", 72, 50, 3),
                                  ("444", "YCBCR", 70, 33, 4),
                                  ("g31", "RGB", 56, 29, 3),
                                  ("440", "YCBCR", 150, 140, 8)])
def test_t1_stripes_on_card_equal_the_cpu_stripes(cuda, case):
    from jpeg_decoder_tpu_torch.parallel import make_mesh
    from jpeg_decoder_tpu_torch.parallel.stripes import (
        _pad_rows, make_stripe_pipeline)

    layout, transform, h, w, n = case
    geometry = t1_geometry(layout, h, w, 8, transform)
    mcu_rows = -(-h // (8 * max(f[1] for f in T1_LAYOUTS[layout])))
    rng = np.random.default_rng(h + w)
    stores = _pad_rows(geometry, [
        rng.integers(-60, 60, (c.blocks_wide * c.blocks_high, 64))
        .astype(np.int16) for c in geometry.components], mcu_rows, n, False)
    qts = tuple(np.full(64, 2, np.uint16) for _ in stores)
    before = jt.LAUNCHES["interleaved_tail"]
    got = make_stripe_pipeline(geometry, mcu_rows, n, make_mesh(
        {"stripe": n}, ["cuda:0"] * n))(stores, qts)
    assert jt.LAUNCHES["interleaved_tail"] - before == n
    want = make_stripe_pipeline(geometry, mcu_rows, n, make_mesh(
        {"stripe": n}, ["cpu"] * n))(stores, qts)
    assert got.is_cuda and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_t1_launches_once_for_a_large_420(cuda, precision):
    with jt.DeviceStreamDecoder(host_threads=1, precision=precision) as dec:
        staged = dec.stage(fixture("large_420.jpg"))
        wires = dec._to_device(staged)
        torch.cuda.synchronize()
        jt.reset_launches()
        img = dec._run_device(staged, wires)
        torch.cuda.synchronize()
    assert jt.LAUNCHES["interleaved_tail"] == 1 and img.is_cuda


def _a1_pair(nat, plan, maps_cpu, maps_card, carry):
    """A1 on the card (one launch) and its plain version on the card and
    on the CPU, for one call."""
    from jpeg_decoder_tpu_torch.entropy.assemble import (assemble_nat,
                                                         assemble_nat_plain)

    before = jt.LAUNCHES["assemble"]
    got = assemble_nat(nat, plan, maps_card, carry)
    assert jt.LAUNCHES["assemble"] - before == 1
    on_card = assemble_nat_plain(nat, plan, maps_card, carry)
    carry_cpu = None if carry is None else carry.cpu()
    on_cpu = assemble_nat_plain(nat.cpu(), plan, maps_cpu, carry_cpu)
    torch.cuda.synchronize()
    assert len(got) == len(on_card) == len(on_cpu)
    for g, w, c in zip(got, on_card, on_cpu):
        assert g.is_cuda and g.is_contiguous()
        assert torch.equal(g, w) and torch.equal(g.cpu(), c)


@pytest.mark.parametrize("case", A1_CASES, ids=[c[0] for c in A1_CASES])
def test_a1_bit_equal_to_plain_on_seeded_plans(cuda, case):
    """Padded grids, restart segments across the kernel's tiles, sequences
    of 36 tiles, groups, carries with high bits set, general maps."""
    from jpeg_decoder_tpu_torch.entropy.assemble import GeneralMaps

    plan, nat, carry = a1_case(case)
    general = plan.structured is None
    nat = torch.from_numpy(nat).to(cuda)
    carry = None if carry is None else torch.from_numpy(carry).to(cuda)
    _a1_pair(nat, plan, GeneralMaps(plan, "cpu") if general else None,
             GeneralMaps(plan, cuda) if general else None, carry)
    if carry is not None:
        _a1_pair(nat, plan, GeneralMaps(plan, "cpu") if general else None,
                 GeneralMaps(plan, cuda) if general else None, carry.T
                 .contiguous().T)


@pytest.mark.parametrize("branch", ["structured", "general"])
@pytest.mark.parametrize("name", SMALL_FIXTURES + ("tower_420.jpg",
                                                   "large_420.jpg"))
def test_a1_bit_equal_to_plain_on_fixture_nat(cuda, name, branch):
    """K1's nat of every fixture scan through A1, both branches (general: a
    copy of the plan without its closed form), alone and as a group of 3
    with a carry."""
    import copy

    from jpeg_decoder_tpu_torch.entropy.assemble import GeneralMaps

    params = DeviceParams(cuda)
    for st in jt.stage_host_bits(fixture(name)).scans:
        dm = torch.from_numpy(st.dm).to(cuda)
        ab, base = unpack_delta(dm)
        nat = decode_chunks(torch.from_numpy(st.words).to(cuda), dm, ab, base,
                            params.tables(st.scan), st.s_max,
                            st.scan.plan.n_blocks)
        plan, cpu_maps, card_maps = st.scan.plan, None, None
        if branch == "general":
            plan = copy.copy(plan)
            plan.structured = None
            cpu_maps, card_maps = GeneralMaps(plan, "cpu"), GeneralMaps(plan,
                                                                        cuda)
        _a1_pair(nat, plan, cpu_maps, card_maps, None)
        group = torch.stack([nat, nat.flip(0), nat])
        carry = torch.arange(3 * plan.ncomp, device=cuda).view(
            plan.ncomp, 3) * 40503 - 2 ** 40
        _a1_pair(group, plan, cpu_maps, card_maps, carry)


def test_a1_refuses_what_it_does_not_take(cuda):
    from jpeg_decoder_tpu_torch.entropy.assemble import (GeneralMaps,
                                                         assemble_nat)

    plan, nat, _carry = a1_case(A1_CASES[1])        # general maps
    nat = torch.from_numpy(nat).to(cuda)
    before = jt.LAUNCHES["assemble"]
    with pytest.raises(ValueError):                 # maps on another device
        assemble_nat(nat, plan, GeneralMaps(plan, "cpu"))
    flat = torch.zeros(nat.numel() + 4, dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):                 # 8 bytes off 16
        assemble_nat(flat[4:].view(nat.shape), plan, GeneralMaps(plan, cuda))
    with pytest.raises(ValueError):                 # carry of the wrong shape
        assemble_nat(nat, plan, GeneralMaps(plan, cuda),
                     torch.zeros(5, dtype=torch.int64, device=cuda))
    assert jt.LAUNCHES["assemble"] == before


def _u1_sizes() -> list:
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import U1_TILE as t

    return sorted({1, 31, 4095, 4096, 4097, t - 1, t, t + 1, 2 * t + 1,
                   4 * t + 3, 6_144, 8_192, 65_536, 98_304, 100_000, 1 << 20,
                   (1 << 20) + 1})


def _seeded_wire(n: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(n)
    return torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(dev)


@pytest.mark.parametrize("n", _u1_sizes())
def test_u1_bit_equal_to_plain(cuda, n):
    """Every bit pattern of the wire word, on wires of one tile and of 2
    to 513 tiles (the tile edges, 2^20 and 2^20 + 1 entries)."""
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import unpack_delta_plain

    dm = _seeded_wire(n, cuda)
    before = jt.LAUNCHES["unpack_delta"]
    got = unpack_delta(dm)
    assert jt.LAUNCHES["unpack_delta"] - before == 1
    for g, w in zip(got, unpack_delta_plain(dm.cpu())):
        assert g.is_cuda and g.is_contiguous() and torch.equal(g.cpu(), w)


def test_u1_a_thousand_launches_in_a_row(cuda):
    """1,000 launches back to back on one stream, each with a new epoch on
    the same status buffer, over wires of 1 to 5 tiles, then across the
    epochs' end (the buffer remade before 2^30)."""
    from jpeg_decoder_tpu_torch import _build
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import (U1_TILE,
                                                             unpack_delta_plain)

    wires = [_seeded_wire(n, cuda) for n in (3 * U1_TILE + 5, 5 * U1_TILE,
                                             2 * U1_TILE + 1, 77)]
    want = [unpack_delta_plain(w.cpu()) for w in wires]
    outs = [unpack_delta(wires[k % 4]) for k in range(1000)]
    for k, got in enumerate(outs):
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want[k % 4]))
    key = ("unpack_delta", wires[0].device,
           torch.cuda.current_stream().cuda_stream)
    buf = _build._status[key][0]
    _build._status[key][1] = (1 << 30) - 3
    for k in range(4):
        got = unpack_delta(wires[k % 3])
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want[k % 3]))
    assert _build._status[key][0] is not buf and _build._status[key][1] == 2


def test_u1_on_two_streams_at_once(cuda):
    """Two streams each run U1 over their own wires at the same time: each
    stream has its own status buffer and epochs."""
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import (U1_TILE,
                                                             unpack_delta_plain)

    wires = [_seeded_wire(n, cuda) for n in (40 * U1_TILE + 1,
                                             33 * U1_TILE - 7)]
    want = [unpack_delta_plain(w.cpu()) for w in wires]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(50):
        for k, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[k].append(unpack_delta(wires[k]))
    torch.cuda.synchronize()
    for k in range(2):
        for got in outs[k]:
            assert all(torch.equal(g.cpu(), w)
                       for g, w in zip(got, want[k]))


def test_u1_interleaved_with_a1_on_one_stream(cuda):
    """U1 and A1 back to back on one stream, each on its own status
    buffer: neither spends the other's epochs."""
    from jpeg_decoder_tpu_torch import _build
    from jpeg_decoder_tpu_torch.entropy.assemble import (assemble_nat,
                                                         assemble_nat_plain)
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import (U1_TILE,
                                                             unpack_delta_plain)

    plan, nat, carry = a1_case(A1_CASES[0])
    nat = torch.from_numpy(nat).to(cuda)
    carry = None if carry is None else torch.from_numpy(carry).to(cuda)
    want_a1 = assemble_nat_plain(nat, plan, None, carry)
    dm = _seeded_wire(7 * U1_TILE + 3, cuda)
    want_u1 = unpack_delta_plain(dm.cpu())
    for _ in range(20):
        got_u1 = unpack_delta(dm)
        got_a1 = assemble_nat(nat, plan, None, carry)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got_u1, want_u1))
        assert all(torch.equal(g, w) for g, w in zip(got_a1, want_a1))
    stream = torch.cuda.current_stream().cuda_stream
    assert _build._status[("unpack_delta", dm.device, stream)][0] is not \
        _build._status[("assemble", nat.device, stream)][0]


@pytest.mark.parametrize("n", [6_144, 65_536])
def test_u1_is_one_kernel_a_call(cuda, n):
    """A call enqueues exactly U1's kernel: no fill of the status buffer,
    no other kernel (the buffer is made by the first call, not timed).
    The trace counts the active step after a warm-up step of its own, as
    a cold trace drops events at its start."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def traced(prof) -> None:
        on_card[:] = [e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]

    on_card = []
    dm = _seeded_wire(n, cuda)
    unpack_delta(dm)
    torch.cuda.synchronize()
    for _attempt in range(3):   # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=traced) as prof:
            for _step in range(2):
                for _ in range(3):
                    unpack_delta(dm)
                torch.cuda.synchronize()
                prof.step()
        if on_card:
            break
    assert len(on_card) == 3 and all("unpack_delta_kernel" in k
                                     for k in on_card), on_card


def test_u1_bit_equal_to_plain_on_real_wires(cuda):
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import unpack_delta_plain
    from jpeg_decoder_tpu_torch.models.stream import merge_scans

    wires = [st.dm for name in SMALL_FIXTURES + ("tower_420.jpg",
                                                 "large_420.jpg")
             for st in jt.stage_host_bits(fixture(name)).scans]
    for name, count in (("tower_420.jpg", 16), ("large_420.jpg", 4),
                        ("large_420.jpg", 16)):
        group = [jt.stage_host_bits(fixture(name)).scans[0]] * count
        (_words, dm), _s_max, _n_blocks = merge_scans(group)
        wires.append(dm)
    for w in wires:
        w = torch.from_numpy(np.ascontiguousarray(w))
        got = unpack_delta(w.to(cuda))
        assert all(torch.equal(g.cpu(), p)
                   for g, p in zip(got, unpack_delta_plain(w)))


@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_a1_and_u1_launch_once_per_image_group_and_stripe(cuda, precision):
    """One U1 per delta-wire scan and one A1 per assembly: a large_420
    decode, a group of 4 tower_420 (one merged wire, one plan), and
    large_420 striped over 4 slots (anchor wires: no U1; one A1 per
    stripe); every A1 call of them bit-equal to its plain version."""
    from jpeg_decoder_tpu_torch.entropy.assemble import assemble_nat_plain
    from jpeg_decoder_tpu_torch.models import graphs, stream
    from jpeg_decoder_tpu_torch.parallel import make_mesh, stripe_bits

    calls = []

    def spy(nat, plan, maps=None, carry=None):
        out = real(nat, plan, maps, carry)
        if not torch.cuda.is_current_stream_capturing():
            calls.append((nat, plan, maps, carry, out))
        return out

    real = stream.assemble_nat
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stream, "assemble_nat", spy)
        mp.setattr(stripe_bits, "assemble_nat", spy)
        with jt.DeviceStreamDecoder(host_threads=1,
                                    precision=precision) as dec:
            staged = dec.stage(fixture("large_420.jpg"))
            wires = dec._to_device(staged)
            torch.cuda.synchronize()
            jt.reset_launches()
            dec._run_device(staged, wires)
            torch.cuda.synchronize()
            assert jt.LAUNCHES["assemble"] == 1
            assert jt.LAUNCHES["unpack_delta"] == 1
            jt.reset_launches()
            dec.decode_stream([fixture("tower_420.jpg")] * 4, batch_size=4)
            torch.cuda.synchronize()
            assert jt.LAUNCHES["assemble"] == 1
            assert jt.LAUNCHES["unpack_delta"] == 1
        mesh = make_mesh({"stripe": 4}, ["cuda:0"] * 4)
        graphs.device_graphs(mesh.first).clear()    # an eager first sight
        with jt.DeviceStreamDecoder(mesh=mesh, host_threads=1) as dec:
            jt.reset_launches()
            dec.decode_striped(fixture("large_420.jpg"))
            torch.cuda.synchronize()
            assert jt.LAUNCHES["assemble"] == 4
            assert jt.LAUNCHES["unpack_delta"] == 0
    assert len(calls) == 6
    for nat, plan, maps, carry, out in calls:
        want = assemble_nat_plain(nat, plan, maps, carry)
        assert all(torch.equal(g, w) for g, w in zip(out, want))


def test_u1_once_for_a_group_of_16_large_420(cuda):
    """`decode_stream(batch_size=16)` over large_420: one merged wire of
    many tiles, one U1 launch, equal to its plain version, and every image
    bit-equal to its batch-1 decode."""
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import (U1_TILE,
                                                             unpack_delta_plain)
    from jpeg_decoder_tpu_torch.models import stream

    calls = []

    def spy(dm):
        out = real(dm)
        if not torch.cuda.is_current_stream_capturing():
            calls.append((dm, out))
        return out

    real = stream.unpack_delta
    blob = fixture("large_420.jpg")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stream, "unpack_delta", spy)
        with jt.DeviceStreamDecoder(host_threads=2) as dec:
            (one,) = dec.decode_stream([blob])
            torch.cuda.synchronize()
            calls.clear()
            jt.reset_launches()
            group = dec.decode_stream([blob] * 16, batch_size=16)
            torch.cuda.synchronize()
            assert jt.LAUNCHES["unpack_delta"] == 1
    assert len(calls) == 1 and calls[0][0].numel() > 4 * U1_TILE
    dm, out = calls[0]
    assert all(torch.equal(g, w.to(cuda))
               for g, w in zip(out, unpack_delta_plain(dm.cpu())))
    assert len(group) == 16 and all(torch.equal(img, one) for img in group)


def _host_tensors(arrays) -> list:
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("images,blocks,entries", P1_SHAPES)
def test_p1_bit_equal_to_plain_on_seeded_wires(cuda, images, blocks,
                                               entries):
    """Duplicate, out-of-range and negative residual indices, an empty
    list, block counts around P1's tiles; two launches where there are
    residuals, one where there are none."""
    from jpeg_decoder_tpu_torch.entropy.prefix import (prefix_stores,
                                                       prefix_stores_plain)

    arrays = _host_tensors(p1_case(images, blocks, entries,
                                   seed=images * 1000 + blocks))
    geometry = whole_geometry(blocks)
    before = jt.LAUNCHES["prefix_rebuild"]
    (got,) = prefix_stores(geometry, *(a.to(cuda) for a in arrays))
    torch.cuda.synchronize()
    assert jt.LAUNCHES["prefix_rebuild"] - before == 1 + (entries > 0)
    (want,) = prefix_stores_plain(geometry, *arrays)
    assert got.is_cuda and torch.equal(got.cpu(), want)
    (plain,) = prefix_stores_plain(geometry, *(a.to(cuda) for a in arrays))
    assert torch.equal(got, plain)


@pytest.mark.parametrize("name", SMALL_FIXTURES + (
    "tower_420.jpg", "large_420.jpg", "q100/q100_420.jpg"))
def test_p1_bit_equal_to_plain_on_fixture_wires(cuda, name):
    from jpeg_decoder_tpu_torch.entropy.prefix import (prefix_stores,
                                                       prefix_stores_plain)
    from jpeg_decoder_tpu_torch.host.staging import stage_host

    st = stage_host(fixture(name))
    arrays = _host_tensors((st.dc, st.ac, st.resid_idx, st.resid_vals))
    got = prefix_stores(st.geometry, *(a.to(cuda) for a in arrays))
    want = prefix_stores_plain(st.geometry, *arrays)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g.cpu(), w)


def test_p1_group_of_16_on_card(cuda):
    """A prefix group of 16 tower_420: one P1 rebuild (two launches) for
    the group, equal to its plain version on the merged wire, and every
    image bit-equal to its batch-1 decode."""
    from jpeg_decoder_tpu_torch.entropy.prefix import (prefix_stores,
                                                       prefix_stores_plain)

    blob = fixture("tower_420.jpg")
    with jt.DeviceStreamDecoder(host_threads=2, interchange="prefix") as dec:
        (one,) = dec.decode_stream([blob])
        group = [dec.stage(blob) for _ in range(16)]
        wires = dec._group_wires("prefix", group)
        torch.cuda.synchronize()
        jt.reset_launches()
        out = dec._run_group("prefix", group, wires)
        torch.cuda.synchronize()
        assert jt.LAUNCHES["prefix_rebuild"] == 2
        got = prefix_stores(group[0].geometry, *wires)
        want = prefix_stores_plain(group[0].geometry, *wires)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(img, one) for img in out)


def test_prefix_route_launches_p1_k2_and_t1_only(cuda):
    """A large_420 prefix image at fast, interleaved: P1's two launches,
    K2 and T1, and no other kernel on the card."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def traced(prof) -> None:
        on_card[:] = [e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]

    on_card = []
    with jt.DeviceStreamDecoder(host_threads=1,
                                interchange="prefix") as dec:
        staged = dec.stage(fixture("large_420.jpg"))
        wires = dec._to_device(staged)
        dec._run_device(staged, wires)
        torch.cuda.synchronize()
        for _attempt in range(3):   # a trace now and then comes back empty
            # The first call warms the profiler up and is not recorded: a
            # trace whose window opened on P1 lost P1's kernels, late in a
            # run of this file under JPEG_TPU_DISABLE_NATIVE=1.
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=traced) as prof:
                for _ in range(2):
                    jt.reset_launches()
                    dec._run_device(staged, wires)
                    torch.cuda.synchronize()
                    prof.step()
            if on_card:
                break
    assert jt.LAUNCHES["prefix_rebuild"] % 2 == 0
    assert jt.LAUNCHES["prefix_rebuild"] // 2 == jt.LAUNCHES[
        "dequant_idct"] == jt.LAUNCHES["interleaved_tail"] >= 1
    kernels = ("dequant_idct_kernel", "interleaved_tail_kernel",
               "prefix_base_kernel", "prefix_resid_kernel")
    assert len(on_card) == 4, on_card
    assert sorted(k for e in on_card for k in kernels if k in e) == \
        list(kernels), on_card


def _mesh_route(route: str, cuda) -> tuple:
    """(call, graph caches, graph runs a call, refs, tol) of a mesh or
    `Decoder` route on slots of the card: the call its entry point on
    inputs staged once. Every shard, line and run of a call decodes an
    image of its own that shares the route's keys (`requantized`
    fixtures, stores with their DC shifted); `refs` holds each output's
    own host decode, in `_tensors(call())`'s order, and `tol` how far an
    output may be from it (3 on the fast tier, else 0)."""
    import dataclasses

    from jpeg_decoder_tpu_torch import decoder as port_decoder
    from jpeg_decoder_tpu_torch.host.ops.pipeline import reconstruct_image
    from jpeg_decoder_tpu_torch.models import graphs
    from jpeg_decoder_tpu_torch.models.service import _host_stage
    from jpeg_decoder_tpu_torch.parallel import (make_batch_pipeline,
                                                 make_mesh,
                                                 make_stripe_pipeline)
    from jpeg_decoder_tpu_torch.parallel.stripe_bits import (
        decode_bits_striped, decode_bits_striped_batch)
    from jpeg_decoder_tpu_torch.parallel.stripes import _pad_rows
    from tools.make_torch_fixtures import requantized

    dev = torch.device("cuda", torch.cuda.current_device())
    cache = graphs.device_graphs(dev)
    towers = [requantized(fixture("tower_420.jpg"), 5 * k) for k in range(8)]
    if route == "mesh_groups":
        mesh = make_mesh({"data": 4}, [dev] * 4)
        dec = jt.DeviceStreamDecoder(mesh=mesh, host_threads=1)
        group = [dec.stage(b) for b in towers]
        return (lambda: dec._decode_group_mesh("bits", group), [dec._graphs],
                4, [_exact(b) for b in towers], 3)
    if route == "stripes":
        mesh = make_mesh({"stripe": 4}, [dev] * 4)
        blobs = [requantized(fixture("large_420.jpg"), step)
                 for step in (0, 7)]
        staged = [jt.stage_host_bits(b) for b in blobs]
        return (lambda: [decode_bits_striped(st, mesh) for st in staged],
                [cache], 2, [_exact(b) for b in blobs], 0)
    if route == "dp_sp":
        mesh = make_mesh({"data": 2, "stripe": 2}, [dev] * 4)
        staged = [jt.stage_host_bits(b) for b in towers[:4]]
        return (lambda: decode_bits_striped_batch(staged, mesh), [cache], 2,
                [np.stack([_exact(b) for b in towers[:4]])], 0)
    geometry, stores, qts = _host_stage(fixture("tower_420.jpg"))
    exact = dataclasses.replace(geometry, precision="exact")
    tol = 3 if geometry.precision == "fast" else 0
    shifts = []
    for k in range(8):
        shifts.append([st.copy() for st in stores])
        for st in shifts[-1]:
            st[:, 0] += 6 * k
    refs = [reconstruct_image(exact, st, qts) for st in shifts]
    if route == "stripe_recon":
        mesh = make_mesh({"stripe": 4}, [dev] * 4)
        rows = geometry.components[0].blocks_high // 2
        fn = make_stripe_pipeline(geometry, rows, 4, mesh)
        padded = [_pad_rows(geometry, shifts[k], rows, 4, False)
                  for k in (0, 3)]
        return (lambda: [fn(p, tuple(qts)) for p in padded], [cache], 2,
                [refs[0], refs[3]], 0)
    if route == "batch":
        mesh = make_mesh({"data": 4}, [dev] * 4)
        fn = make_batch_pipeline(geometry, mesh)
        batched = tuple(np.stack([st[c] for st in shifts])
                        for c in range(len(stores)))
        return (lambda: fn(batched, qts), [cache], 4,
                [np.stack(refs[k:k + 2]) for k in range(0, 8, 2)], tol)
    return (lambda: [port_decoder.reconstruct_tensor(geometry, shifts[k], qts,
                                                     dev) for k in (0, 3)],
            [cache], 2, [refs[0], refs[3]], tol)


def _exact(blob: bytes) -> np.ndarray:
    return jt.host.decoder.Decoder(blob, backend="numpy",
                                   precision="exact").decode_array()


def _held(outs: list, refs: list, tol: int) -> None:
    """Each output against its own reference, cropped to its extent."""
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        got = out.cpu().numpy()[tuple(slice(0, n) for n in ref.shape)]
        assert got.shape == ref.shape
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() \
            <= tol


MESH_ROUTES = ("mesh_groups", "stripes", "dp_sp", "stripe_recon", "batch",
               "decoder")


@pytest.mark.parametrize("route", ["bits", "prefix", "lossless", "hetero",
                                   *MESH_ROUTES])
def test_device_routes_never_synchronise(cuda, route):
    """`_run_device` and `_run_group` on the bits, prefix and lossless
    routes and on a hetero bits group (the six mixed sizes and two
    repeats) under `torch.cuda.set_sync_debug_mode("error")`: no operation
    on them waits for the card (after one warm-up decode, which copies
    the per-table constants to the card once, and a second, which
    captures the graphs); on every route every call there is a graph
    replay (on the hetero route one sweep and six parts, each part's row
    copy included), the H2D submission that fills a graph's inputs
    included. The mesh and `Decoder` routes (`_mesh_route`: a group of 8
    over 4 data slots, large_420 over 4 stripes, DP x SP, the striped and
    the batched reconstructions, `Decoder`'s) likewise through their
    entry points: a replay per data shard or line, outputs equal and
    each within its tolerance of its own image's host decode (each shard,
    line and run an image of its own, of one key)."""
    from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

    if route in MESH_ROUTES:
        call, caches, runs, refs, tol = _mesh_route(route, cuda)
        for _ in range(2):      # the keys' first sight, then their capture
            want = [t.clone() for t in _tensors(call())]
        _held(want, refs, tol)
        torch.cuda.synchronize()
        hits = sum(c.hits for c in caches)
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = [_tensors(call()) for _ in range(3)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert sum(c.hits for c in caches) - hits == 3 * runs
        assert all(torch.equal(a, b) for out in outs
                   for a, b in zip(out, want))
        for out in outs:
            _held(out, refs, tol)
        return
    if route == "lossless":
        blobs = [sof3_jpeg(sof3_samples(64, 48, 3, 16, 0, seed=4), 6, 0,
                           16)] * 4
    elif route == "hetero":
        blobs = [fixture(n) for n in MIXED_SIZES]
        blobs += blobs[:2]
    else:
        blobs = [fixture("large_420.jpg")] * 4
    interchange = "prefix" if route == "prefix" else "bits"
    kind = "bits" if route == "hetero" else route
    with jt.DeviceStreamDecoder(host_threads=1,
                                interchange=interchange) as dec:
        staged = dec.stage(blobs[0])
        group = [dec.stage(blob) for blob in blobs]
        for _ in range(2):      # a key's first sight, then its capture
            wires = dec._to_device(staged)
            group_wires = dec._group_wires(kind, group)
            dec._run_device(staged, wires)
            dec._run_group(kind, group, group_wires)
        torch.cuda.synchronize()
        hits = dec._graphs.hits
        torch.cuda.set_sync_debug_mode("error")
        try:
            one = dec._run_device(staged, wires)
            many = dec._run_group(kind, group, group_wires)
            for _ in range(3):      # a warmed key's replays, new inputs
                again = dec._run_device(staged, dec._to_device(staged))
                many_again = dec._run_group(kind, group,
                                            dec._group_wires(kind, group))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        replays = dec._graphs.hits - hits
    assert torch.equal(again, one) and torch.equal(many[0], one)
    assert all(torch.equal(a, b) for a, b in zip(many, many_again))
    assert all(torch.equal(img, one) for img, blob in zip(many, blobs)
               if blob == blobs[0])
    assert replays == {"hetero": 32}.get(route, 8)


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _tensors(o)]


def test_p1_on_two_streams_at_once(cuda):
    """P1 beside another stream's P1: two streams, each launching it on
    its own wire 50 times without waiting on the other, as slots of one
    card do (phases 19 and 20); every call bit-equal to plain."""
    from jpeg_decoder_tpu_torch.entropy.prefix import (prefix_stores,
                                                       prefix_stores_plain)
    from jpeg_decoder_tpu_torch.host.staging import stage_host

    wires, wants = [], []
    for name in ("large_420.jpg", "tower_420.jpg"):
        st = stage_host(fixture(name))
        wire = [a.to(cuda) for a in _host_tensors(
            (st.dc, st.ac, st.resid_idx, st.resid_vals))]
        wires.append((st.geometry, wire))
        wants.append(prefix_stores_plain(st.geometry, *wire))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    for _ in range(50):
        for k, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                outs[k].append(prefix_stores(wires[k][0], *wires[k][1]))
    torch.cuda.synchronize()
    for k in range(2):
        assert all(torch.equal(g, w) for out in outs[k]
                   for g, w in zip(out, wants[k])), k


def test_p1_refuses_what_it_does_not_take(cuda):
    from jpeg_decoder_tpu_torch.entropy.prefix import prefix_stores

    dc, ac, idx, vals = (a.to(cuda) for a in _host_tensors(
        p1_case(1, 40, 30, seed=1)))
    geometry = whole_geometry(40)
    before = jt.LAUNCHES["prefix_rebuild"]
    for args in ((dc, ac, idx.long(), vals), (dc.int(), ac, idx, vals),
                 (dc, ac[:, :20], idx, vals), (dc, ac, idx, vals[:-1]),
                 (dc, ac, idx.cpu(), vals)):
        with pytest.raises(ValueError):
            prefix_stores(geometry, *args)
    assert jt.LAUNCHES["prefix_rebuild"] == before


@pytest.mark.parametrize("name", SMALL_FIXTURES + ("tower_420.jpg",
                                                  "large_420.jpg"))
def test_d1_bit_equal_to_plain_on_fixture_plans(cuda, name):
    """Seeded full-range nat of 1 and 3 images of every fixture's plan
    (large_420: 315 of D1's 256-block CTAs an image), one launch a call."""
    from jpeg_decoder_tpu_torch.entropy.assemble import (dc_totals,
                                                         dc_totals_plain)

    (st,) = jt.stage_host_bits(fixture(name)).scans
    plan = st.scan.plan
    rng = np.random.default_rng(len(name))
    for images in (1, 3):
        nat = torch.from_numpy(rng.integers(-32768, 32768,
                                            (images, plan.n_blocks, 64),
                                            dtype=np.int16))
        before = jt.LAUNCHES["dc_totals"]
        got = dc_totals(nat.to(cuda), plan)
        torch.cuda.synchronize()
        assert jt.LAUNCHES["dc_totals"] == before + 1
        assert got.dtype == torch.int64 and torch.equal(
            got.cpu(), dc_totals_plain(nat, plan))
    assert torch.equal(dc_totals(nat[0].to(cuda), plan).cpu(),
                       dc_totals_plain(nat[0], plan))


def test_d1_a_thousand_launches_in_a_row(cuda):
    """The accumulators go back to 0 after every launch: 1,000 calls of
    two sizes in turn, each equal to its plain version, and the status
    words all 0 after them."""
    from jpeg_decoder_tpu_torch.entropy.assemble import (dc_totals,
                                                         dc_totals_plain)

    plans, nats = [], []
    for name in ("tower_420.jpg", "large_420.jpg"):
        (st,) = jt.stage_host_bits(fixture(name)).scans
        plans.append(st.scan.plan)
        nats.append(torch.from_numpy(np.random.default_rng(7).integers(
            -32768, 32768, (1, st.scan.plan.n_blocks, 64),
            dtype=np.int16)).to(cuda))
    want = [dc_totals_plain(n, p) for n, p in zip(nats, plans)]
    outs = [dc_totals(nats[i % 2], plans[i % 2]) for i in range(1000)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, want[i % 2]) for i, o in enumerate(outs))
    from jpeg_decoder_tpu_torch import _build

    dev = nats[0].device
    key = ("dc_totals", dev, torch.cuda.current_stream(dev).cuda_stream)
    assert int(_build._status[key][0].count_nonzero()) == 0


@pytest.mark.parametrize("n", [4, 8])
def test_d1_once_per_stripe(cuda, n):
    """large_420 striped over n slots: one D1 launch a stripe, each call
    equal to its plain version, K1 writing each stripe's one nat, the
    image bit-equal to the host exact decode. The card's process-wide
    graph cache is emptied first, so the call is its key's first sight,
    dispatched eagerly through the wrapper the spy sees."""
    from jpeg_decoder_tpu_torch.entropy.assemble import dc_totals_plain
    from jpeg_decoder_tpu_torch.host.decoder import Decoder as HostDecoder
    from jpeg_decoder_tpu_torch.models import graphs
    from jpeg_decoder_tpu_torch.parallel import make_mesh, stripe_bits

    calls = []
    real = stripe_bits.dc_totals

    def spy(nat, plan):
        out = real(nat, plan)
        calls.append((nat, plan, out))
        return out

    data = fixture("large_420.jpg")
    mesh = make_mesh({"stripe": n}, ["cuda:0"] * n)
    graphs.device_graphs(mesh.first).clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stripe_bits, "dc_totals", spy)
        with jt.DeviceStreamDecoder(mesh=mesh, host_threads=1) as dec:
            jt.reset_launches()
            img = dec.decode_striped(data)
            torch.cuda.synchronize()
    assert jt.LAUNCHES["dc_totals"] == n == len(calls)
    assert jt.LAUNCHES["huffman_decode"] == n
    for nat, plan, out in calls:
        assert nat.shape[0] == 1 and torch.equal(out,
                                                 dc_totals_plain(nat, plan))
    gold = HostDecoder(data, backend="numpy", precision="exact")
    assert np.array_equal(img.cpu().numpy(), gold.decode_array())


def test_k1_into_rows_of_a_larger_tensor_on_card(cuda):
    """`decode_chunks(out=)` on the card: K1 writes the rows it is given,
    equal to the allocating call, the rows around them untouched."""
    params = DeviceParams(cuda)
    (st,) = jt.stage_host_bits(fixture("tower_420.jpg")).scans
    dm = torch.from_numpy(st.dm).to(cuda)
    ab, base = unpack_delta(dm)
    args = (torch.from_numpy(st.words).to(cuda), dm, ab, base,
            params.tables(st.scan), st.s_max, st.scan.plan.n_blocks)
    nat = torch.full((3, st.scan.plan.n_blocks, 64), -7, dtype=torch.int16,
                     device=cuda)
    got = decode_chunks(*args, out=nat[1])
    assert got.data_ptr() == nat[1].data_ptr()
    assert torch.equal(nat[1], decode_chunks(*args))
    assert (nat[0] == -7).all() and (nat[2] == -7).all()


# The compiled dispatch (`models/graphs.py`): the bits device half captured
# once per key as a CUDA graph and replayed.
GRAPH_ROUTES = [(layout, precision, batch)
                for layout in ("interleaved", "planar", "planar-pallas")
                for precision in ("fast", "exact") for batch in (1, 0)]


def _route_wires(dec, blob, batch: int):
    """(first, run, eager) on `blob`'s key: one image (batch 1), or
    tower_420 x 4 as one group (batch 0). `first` the output of the key's
    first call (eager, off any graph); `run` and `eager` the calls on the
    inputs the second call landed in the key's graph."""
    staged = dec.stage(blob)
    if batch == 1:
        first = dec._run_device(staged, dec._to_device(staged))[None]
        fill = dec._to_device(staged)
        return (first, lambda: dec._run_device(staged, fill)[None],
                lambda: dec._run_device_eager(staged, fill)[None])
    group = [staged] * 4
    first = torch.stack(dec._run_group("bits", group,
                                       dec._group_wires("bits", group)))
    fill = dec._group_wires("bits", group)
    return (first,
            lambda: torch.stack(dec._run_group("bits", group, fill)),
            lambda: torch.stack(dec._run_group_eager("bits", group, fill)))


@pytest.mark.parametrize("layout,precision,batch", GRAPH_ROUTES)
def test_graph_replay_equals_eager_body(cuda, layout, precision, batch):
    """large_420 (one image) and tower_420 x 4 (one group) in every layout
    at both precisions: the key's first call (eager, off any graph), the
    second (the warm-up on the graph's inputs, then the capture), two
    replays and the eager body on the graph's inputs all bit-equal; one
    capture, two replays; the launches a call counts
    equal to the eager body's, by kernel (5 at large_420: K1, U1, A1, K2
    or E1, T1)."""
    from jpeg_decoder_tpu_torch.models.graphs import BitsGraph

    blob = fixture("large_420.jpg" if batch == 1 else "tower_420.jpg")
    with jt.DeviceStreamDecoder(host_threads=1, layout=layout,
                                precision=precision) as dec:
        first, run, eager = _route_wires(dec, blob, batch)
        torch.cuda.synchronize()
        jt.reset_launches()
        replays = [run() for _ in range(3)]
        torch.cuda.synchronize()
        replayed = dict(jt.LAUNCHES)
        jt.reset_launches()
        body = eager()
        torch.cuda.synchronize()
        stats = dec._graphs.stats()
        (graph,) = dec._graphs._graphs.values()
    assert isinstance(graph, BitsGraph)
    assert stats["captures"] == 1 and stats["hits"] == 2
    assert all(torch.equal(r, first) for r in replays + [body])
    assert replayed == {k: 3 * v for k, v in jt.LAUNCHES.items()}
    if batch == 1 and layout == "interleaved":
        assert {k: v for k, v in jt.LAUNCHES.items() if v} == {
            "huffman_decode": 1, "unpack_delta": 1, "assemble": 1,
            "interleaved_tail": 1,
            ("dequant_idct" if precision == "fast" else "idct_exact"): 1}


def test_graph_outputs_stay_the_callers(cuda):
    """tower_420 and its optimised-table twin through one graph, in turns:
    every output equal to its own image's first decode, and each tensor
    handed out unchanged after the later replays."""
    blobs = [fixture("tower_420.jpg"), fixture("optimized/"
                                                "tower_420_opt.jpg")]
    with jt.DeviceStreamDecoder(host_threads=1) as dec:
        want = [dec.decode_stream([b])[0].clone() for b in blobs]
        outs = dec.decode_stream(blobs * 4)
        torch.cuda.synchronize()
        assert dec._graphs.stats()["graphs"] == 1
    assert not torch.equal(want[0], want[1])
    for i, img in enumerate(outs):
        assert torch.equal(img, want[i % 2]), i


def test_graph_epochs_cross_their_wrap(cuda):
    """A group of 16 large_420 (U1 over many tiles, A1 over many tiles)
    replayed with each device-epoch buffer's word 0 set two launches below
    the end of its epochs (2^32 for A1, 2^30 for U1): every replay across
    the wrap bit-equal to the first decode, word 0 back at small epochs."""
    blob = fixture("large_420.jpg")
    with jt.DeviceStreamDecoder(host_threads=1) as dec:
        group = [dec.stage(blob)] * 16
        first = torch.stack(dec._run_group("bits", group,
                                           dec._group_wires("bits", group)))
        fill = dec._group_wires("bits", group)
        dec._run_group("bits", group, fill)     # the capture
        bufs = fill.graph.scope.epochs.buffers
        assert set(bufs) == {"assemble", "unpack_delta"}
        for kernel, ends in (("assemble", 1 << 32), ("unpack_delta", 1 << 30)):
            w = (ends - 2) << 32
            bufs[kernel][0][0] = w - (1 << 64) if w >= 1 << 63 else w
        outs = [torch.stack(dec._run_group("bits", group, fill))
                for _ in range(4)]
        torch.cuda.synchronize()
        epochs = {k: int(b[0][0]) >> 32 for k, b in bufs.items()}
    assert all(torch.equal(o, first) for o in outs)
    assert epochs == {"assemble": 2, "unpack_delta": 2}


# The hetero group's graphs: a sweep graph and a graph per (plan, count
# bucket), the mixed group of 8 and a second composition.
HETERO_ROUTES = [("interleaved", "fast"), ("interleaved", "exact"),
                 ("planar", "exact"), ("planar-pallas", "fast")]
HETERO_SECOND = (5, 4, 3, 2, 1, 0, 4, 3)


@pytest.mark.parametrize("layout,precision", HETERO_ROUTES)
def test_hetero_graph_replay_equals_eager_body(cuda, layout, precision):
    """The six mixed sizes and two repeats as one hetero group: the keys'
    first call (eager, off any graph, no graph made), the second (the
    warm-ups and captures of one sweep graph and six part graphs), two
    replays and the eager body on the graphs' inputs all bit-equal; one
    capture a key; the launches a call counts equal to the eager body's
    (K1 and U1 once, A1, the IDCT and the tail once a part). A second
    composition replays the same sweep graph and two part graphs at other
    offsets, and a third runs a new sweep key eagerly before six warm part
    graphs: each image bit-equal to the same fixture's in the first."""
    blobs = [fixture(n) for n in MIXED_SIZES]
    cell = blobs + blobs[:2]
    with jt.DeviceStreamDecoder(host_threads=1, layout=layout,
                                precision=precision) as dec:
        group = [dec.stage(b) for b in cell]
        first = dec._run_group("bits", group,
                               dec._group_wires("bits", group))
        assert len(dec._graphs) == 0
        torch.cuda.synchronize()
        jt.reset_launches()
        replays = [dec._run_group("bits", group,
                                  dec._group_wires("bits", group))
                   for _ in range(3)]
        torch.cuda.synchronize()
        replayed = dict(jt.LAUNCHES)
        jt.reset_launches()
        body = dec._run_group_eager("bits", group,
                                    dec._group_wires("bits", group))
        torch.cuda.synchronize()
        eager = {k: v for k, v in jt.LAUNCHES.items() if v}
        stats = dec._graphs.stats()
        group2 = [dec.stage(blobs[i]) for i in HETERO_SECOND]
        seconds = [dec._run_group("bits", group2,
                                  dec._group_wires("bits", group2))
                   for _ in range(3)]
        torch.cuda.synchronize()
        # The six sizes once each: a sweep key at its first sight (eager)
        # before six part graphs that are warm.
        hits = dec._graphs.hits
        group3 = [dec.stage(b) for b in blobs]
        third = dec._run_group("bits", group3,
                               dec._group_wires("bits", group3))
        torch.cuda.synchronize()
        third_replays = dec._graphs.hits - hits
        sweeps = [k for k in dec._graphs._graphs if k[0] == "sweep"]
    assert stats == {"graphs": 7, "captures": 7, "hits": 14}
    for out in [first] + replays:
        assert all(torch.equal(a, b) for a, b in zip(out, body))
    assert {k: v for k, v in replayed.items() if v} == {
        k: 3 * v for k, v in eager.items()}
    parts = len(MIXED_SIZES)
    idct = "dequant_idct" if precision == "fast" \
        or layout == "planar-pallas" else "idct_exact"
    tail = "fused_tail" if layout == "planar-pallas" else "interleaved_tail"
    assert eager == {
        "huffman_decode": 1, "unpack_delta": 1, "assemble": parts,
        idct: parts, tail: parts}
    assert len(sweeps) == 1
    for imgs in seconds:
        assert all(torch.equal(img, body[i])
                   for i, img in zip(HETERO_SECOND, imgs))
    assert third_replays == parts
    assert all(torch.equal(img, body[i]) for i, img in enumerate(third))


def test_a_failed_capture_raises(cuda):
    """A body that synchronises while it is captured (here a spy on A1)
    makes the capture fail: the key's first call (eager, off any graph)
    decodes, its second (the capture) raises and the key keeps no graph;
    so again from the start (no eager fallback at a capture)."""
    from jpeg_decoder_tpu_torch.models import stream

    real = stream.assemble_nat

    def syncing(*args, **kw):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        return real(*args, **kw)

    blob = fixture("tower_420.jpg")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stream, "assemble_nat", syncing)
        with jt.DeviceStreamDecoder(host_threads=1) as dec:
            for _ in range(2):
                dec.decode_stream([blob])
                assert len(dec._graphs) == 0
                with pytest.raises(RuntimeError):
                    dec.decode_stream([blob])
                assert len(dec._graphs) == 0
    torch.cuda.synchronize()

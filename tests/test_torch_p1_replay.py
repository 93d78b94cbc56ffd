"""Kernels P1 (`csrc/prefix_rebuild.cu`) and D1 (`csrc/dc_totals.cu`)
replayed on the CPU from their own sources, through the shim of
`tests/test_torch_a1_replay.py`: each .cu compiled by the host's g++
(C++20), every thread of a CTA on a host thread, `__syncthreads()` a
barrier, a shuffle an exchange through memory, `__constant__` a plain
table, `atomicCAS` a compare-exchange that returns the old word, and
`__threadfence`, `__ldcg` and `__stcg` a fence and relaxed atomic
accesses. Both run the constants the card runs.

The CTAs of a launch run in waves: one after another, or three at a time.
P1's output is poisoned before its base pass, so a row or a piece left
unwritten shows; its residual pass runs after the base pass, as the two
launches do on one stream, with duplicate indices in one wave, so a CAS
that loses an update or touches the other half of its word changes the
result. D1's partial sums are poisoned and its ticket counter must be 0
again after the launch.

Tolerance 0 against the plain versions (`prefix_stores_plain`,
`dc_totals_plain`): P1 on every fixture's prefix wire (stage_host), the
q100 fixture, whose residuals fill zigzag slots 16-63, a group of 3 tower_420
merged as the stream merges it, and seeded wires with duplicate,
out-of-range and negative indices, an empty residual list, a residual on
each half of a 32-bit word, block counts around the 256-block tile and an
AC array off its 16-byte boundary; D1 on every fixture's structured plan
and the stripes of large_420 at 4 and stripe_420 at 8, with 1 to 3 images
and 1 to 53 of its 256-MCU CTAs an image. This checks the kernels' tile
arithmetic and ordering, not the card: the card runs the same sources in
`tests/test_torch_cuda.py` and `chip_smoke.py` phase 26.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jpeg_decoder_tpu_torch as jt
from jpeg_decoder_tpu_torch.entropy import assemble, prefix
from jpeg_decoder_tpu_torch.entropy.assemble import dc_totals_plain
from jpeg_decoder_tpu_torch.entropy.prefix import prefix_stores_plain
from jpeg_decoder_tpu_torch.host.staging import _ZIGZAG_OF_NATURAL, stage_host
from jpeg_decoder_tpu_torch.models.stream import DeviceStreamDecoder
from jpeg_decoder_tpu_torch.parallel.stripe_bits import split_anchored_stripes

from test_torch_a1_replay import CONFIG, SHIM, _host_source
from torch_inputs import (P1_SHAPES, SMALL_FIXTURES, fixture, p1_case,
                          whole_geometry)

CSRC = Path(prefix.__file__).resolve().parent.parent / "csrc"
POISON = -23131                                             # 0xA5A5


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel sources on the host")
    d = tmp_path_factory.mktemp("p1_replay")
    (d / "shim.h").write_text(SHIM)
    objs = []
    for name in ("prefix_rebuild.cu", "dc_totals.cu"):
        src = d / (name[:-3] + ".cc")
        src.write_text(_host_source((CSRC / name).read_text()))
        objs.append(str(src))
    (d / "config.cc").write_text(CONFIG)
    objs.append(str(d / "config.cc"))
    res = subprocess.run([gxx, "-O1", "-std=c++20", "-shared", "-fPIC",
                          "-pthread", "-Wno-unknown-pragmas", "-I", str(d),
                          "-o", str(d / "libp1.so"), *objs],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lib = ctypes.CDLL(str(d / "libp1.so"))
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.jdt_prefix_base.argtypes = [p, p, q, p, p]
    lib.jdt_prefix_base.restype = i
    lib.jdt_prefix_resid.argtypes = [p, p, q, p, q, p]
    lib.jdt_prefix_resid.restype = i
    lib.jdt_dc_totals.argtypes = [p, q, i, i, i, p, p, p, q, p]
    lib.jdt_dc_totals.restype = i
    lib.replay_config.argtypes = [ctypes.c_uint, i, i]
    return lib


def replayed_p1(lib, dc, ac, resid_idx, resid_vals, wave: int):
    """P1 through the replayed kernels with the wrapper's own checks and
    launches (`_check_p1`, `_p1_launches`), its output poisoned first:
    the flat int16 stores."""
    dc = dc.reshape(-1, dc.shape[-1])
    prefix._check_p1(dc, ac, resid_idx, resid_vals)
    out = torch.full((dc.numel() * 64,), POISON, dtype=torch.int16)
    lib.replay_config(wave, 0x5A + wave, 0)
    errs = prefix._p1_launches(lib, dc, ac, resid_idx, resid_vals, out,
                               None)
    assert [e for _what, e in errs] == [0] * (1 + bool(resid_idx.numel()))
    return out


def _check_p1(lib, dc, ac, resid_idx, resid_vals, waves=(1, 3)):
    (want,) = prefix_stores_plain(whole_geometry(dc.shape[-1]), dc, ac, resid_idx,
                                  resid_vals)
    for wave in waves:
        got = replayed_p1(lib, dc, ac, resid_idx, resid_vals, wave)
        assert torch.equal(got, want.reshape(-1)), wave


def _tensors(arrays) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("images,blocks,entries", P1_SHAPES)
def test_replayed_p1_bit_equal_to_plain_on_seeded_wires(lib, images, blocks,
                                                        entries):
    _check_p1(lib, *_tensors(p1_case(images, blocks, entries,
                                     seed=images * 1000 + blocks)))


def test_replayed_p1_each_half_of_a_word(lib):
    """Residuals on the low and the high half of one 32-bit word, each
    alone and both together, with sums that carry out of 16 bits."""
    dc, ac, _idx, _vals = _tensors(p1_case(1, 3, 0, seed=5))
    for idx in ([64], [65], [64, 65], [65, 64, 65, 64], [127, 126, 127]):
        vals = torch.full((len(idx),), 32767, dtype=torch.int16)
        _check_p1(lib, dc, ac, torch.tensor(idx, dtype=torch.int32), vals)


def test_replayed_p1_ac_off_16_bytes(lib):
    """An AC array that starts one byte past a 16-byte boundary takes the
    byte loads; full tiles and a ragged one."""
    dc, ac, idx, vals = _tensors(p1_case(1, 600, 500, seed=9))
    raw = torch.zeros(ac.numel() + 16, dtype=torch.int8)
    off = (1 - raw.data_ptr()) % 16
    shifted = raw[off:off + ac.numel()]
    shifted.copy_(ac.reshape(-1))
    assert shifted.data_ptr() % 16 == 1
    _check_p1(lib, dc, shifted.view(1, 600, 15), idx, vals)


def _prefix_wire(staged) -> tuple:
    return _tensors((staged.dc, staged.ac, staged.resid_idx,
                     staged.resid_vals))


@pytest.mark.parametrize("name", SMALL_FIXTURES + ("tower_420.jpg",))
def test_replayed_p1_on_fixture_wires(lib, name):
    _check_p1(lib, *_prefix_wire(stage_host(fixture(name))))


def test_replayed_p1_on_a_q100_image(lib):
    """`q100/q100_420.jpg`: its 45,917 residuals fill every zigzag slot
    16-63."""
    staged = stage_host(fixture("q100/q100_420.jpg"))
    real = staged.resid_idx[staged.resid_idx < staged.total_coeffs]
    assert len(np.unique(_ZIGZAG_OF_NATURAL[real % 64])) == 48
    _check_p1(lib, *_prefix_wire(staged))


def test_replayed_p1_on_a_merged_group(lib):
    """Three tower_420 merged as `_group_wires` merges a prefix group: the
    residuals offset image by image, the padding at the sink."""
    staged = [stage_host(fixture("tower_420.jpg")) for _ in range(3)]
    with DeviceStreamDecoder(device="cpu", host_threads=1,
                             interchange="prefix") as dec:
        wires = dec._group_wires("prefix", staged)
    _check_p1(lib, *(w.contiguous() for w in wires))


def replayed_d1(lib, nat, plan, wave: int):
    """`dc_totals` through the replayed kernel with the wrapper's own
    checks and launch (`_d1_prepare`, `_d1_launch`), the partial sums
    poisoned and the output too; checks that the counter is 0 again."""
    out, meta, ctas = assemble._d1_prepare(nat, plan)
    out.fill_(-0x5A5A5A5A5A5A5A5A)
    status = torch.from_numpy(np.random.default_rng(ctas).integers(
        -2 ** 62, 2 ** 62, 1 + ctas * out.shape[1] + 3))
    status[0] = 0
    lib.replay_config(wave, 0x5A + wave, 0)
    assert assemble._d1_launch(lib, nat, plan, out, meta, status, None) == 0
    assert int(status[0]) == 0, "the counter must be 0 after the launch"
    return out


def _check_d1(lib, nat, plan, waves=(1, 3)):
    want = dc_totals_plain(nat, plan)
    for wave in waves:
        assert torch.equal(replayed_d1(lib, nat, plan, wave), want), wave


def _seeded_nat(plan, images: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-32768, 32768,
                                         (images, plan.n_blocks, 64),
                                         dtype=np.int16))


@pytest.mark.parametrize("name", SMALL_FIXTURES + ("tower_420.jpg",
                                                  "large_420.jpg"))
def test_replayed_d1_bit_equal_to_plain_on_fixture_plans(lib, name):
    """Every fixture's structured plan (small_dri restart-segmented: D1
    sums every block alike; large_420's 13,440 MCUs: 53 CTAs an image, so
    the last CTA's warps add more than 32 partials each), 1 and 3 images
    of full-range DC values."""
    (st,) = jt.stage_host_bits(fixture(name)).scans
    plan = st.scan.plan
    assert plan.structured is not None
    for images in (1, 3):
        _check_d1(lib, _seeded_nat(plan, images, len(name) + images), plan)


@pytest.mark.parametrize("name,stripes", [("large_420.jpg", 4),
                                          ("stripe_420.jpg", 8)])
def test_replayed_d1_on_stripe_plans(lib, name, stripes):
    """The stripe plans of large_420 at 4 (3,456 MCUs: 14 CTAs an image)
    and stripe_420 at 8, two images of a DP shard; the int64 sums keep
    their high bits against the plain version's."""
    scan = jt.stage_host_bits(fixture(name)).scans[0].scan
    plan = split_anchored_stripes(scan, stripes).plan
    assert plan.structured[0][0] > 256 or name != "large_420.jpg"
    _check_d1(lib, _seeded_nat(plan, 2, stripes), plan)


def test_replayed_d1_single_image_view(lib):
    """nat of one image, [n_blocks, 64], as `dc_totals` also takes it."""
    (st,) = jt.stage_host_bits(fixture("tower_420.jpg")).scans
    plan = st.scan.plan
    nat = _seeded_nat(plan, 1, 0)
    got = replayed_d1(lib, nat, plan, 3)
    assert torch.equal(got[0], dc_totals_plain(nat[0], plan))

"""Kernels P1 (`csrc/prefix_rebuild.cu`) and D1 (`csrc/dc_totals.cu`)
replayed on the CPU from their own sources, through the shim of
`tests/test_torch_a1_replay.py`: each .cu compiled by the host's g++
(C++20), every thread of a CTA on a host thread, `__syncthreads()` a
barrier, a shuffle an exchange through memory, `__constant__` a plain
table, 32- and 64-bit `atomicAdd` atomic_ref adds that return the old
value. Both run the constants the card runs.

The CTAs of a launch run in waves: one after another, or three at a time.
P1's base pass takes a 128-block tile a CTA; its residual pass follows in
a second launch, so duplicate indices fall in one wave and residuals land
in tiles that other CTAs wrote. A cp.async copy lands only when its thread
waits for it (the latest the card may land it), so a tile read before the
wait changes the result. Shared memory and P1's output are poisoned
first, so a staged row or a piece left unwritten shows; a residual add
that loses a carry's correction, or corrects the wrong half of its word,
changes the result.

D1's status buffer holds the accumulators past word 0, 0 before the
launch, and words past them poisoned: after the launch word 0 and the
accumulators must be 0 again and the words past them untouched.

Tolerance 0 against the plain versions (`prefix_stores_plain`,
`dc_totals_plain`): P1 on every fixture's prefix wire (stage_host), the
q100 fixture, whose residuals fill zigzag slots 16-63, a group of 3
tower_420 merged as the stream merges it, and seeded wires with duplicate,
out-of-range and negative indices, an empty residual list, a residual on
each half of a 32-bit word, block counts around P1's tiles and an AC
array off its 16-byte boundary; D1 on every fixture's structured plan
and the stripes of large_420 at 4 and stripe_420 at 8, with 1 to 3 images,
block counts that leave the last of its 256-block CTAs ragged. This checks
the kernels' tile arithmetic and ordering, not the card: the card runs the
same sources in `tests/test_torch_cuda.py` and `chip_smoke.py` phase 26.
"""

import ctypes
import re
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
from jpeg_decoder_tpu_torch.host.staging import (_ZIGZAG_OF_NATURAL, PREFIX_K,
                                                 stage_host)
from jpeg_decoder_tpu_torch.models import stream as port_stream
from jpeg_decoder_tpu_torch.models.stream import DeviceStreamDecoder
from jpeg_decoder_tpu_torch.parallel.stripe_bits import split_anchored_stripes

from test_torch_a1_replay import CONFIG, SHIM, _host_source
from torch_inputs import (P1_SHAPES, SMALL_FIXTURES, fixture, p1_case,
                          whole_geometry)

CSRC = Path(prefix.__file__).resolve().parent.parent / "csrc"
POISON = -23131                                             # 0xA5A5

# What P1 and D1 use beyond the A1 replay's shim: `cudaError_t`, cp.async
# copies that land when their thread waits for them, `__stwb`, a warp's
# `__reduce_add_sync` (the 64-bit atomics are in the A1 replay's shim,
# whose kernels take them too).
P1_SHIM = r"""
#pragma once
#include "shim.h"
typedef int cudaError_t;
enum { cudaSuccess = 0 };
struct PendingCopy { void* dst; const void* src; };
inline thread_local std::vector<PendingCopy> g_open;
inline void cp_async16(void* dst, const void* src) {
  g_open.push_back({dst, src});
}
inline void cp_async_wait_all() {
  for (const PendingCopy& c : g_open) std::memcpy(c.dst, c.src, 16);
  g_open.clear();
}
// A warp's sum: each lane's value through memory between two barriers of
// the warp's 32 threads, added by every lane.
inline int __reduce_add_sync(unsigned, int v) {
  const int t = threadIdx.x, w = t >> 5;
  g_cta->xch[t] = static_cast<uint32_t>(v);
  g_cta->warps[w]->arrive_and_wait();
  uint32_t sum = 0;
  for (int i = 0; i < 32; ++i)
    sum += static_cast<uint32_t>(g_cta->xch[(w << 5) + i]);
  g_cta->warps[w]->arrive_and_wait();
  return static_cast<int>(sum);
}
template <class T> void __stwb(T* p, T v) { *p = v; }
"""


def _p1_host_source(src: str) -> str:
    """A .cu as `_host_source` makes it, with P1_SHIM included and P1's
    cp.async helpers the shim's."""
    def sub(pattern, repl):
        nonlocal src
        src, n = re.subn(pattern, repl, src, flags=re.S)
        assert n == 1, pattern

    sub(r"#include <cuda_runtime.h>\n",
        '#include <cuda_runtime.h>\n#include "p1_shim.h"\n')
    if "cp_async16" in src:
        sub(r"__device__ __forceinline__ void cp_async16\(.*?\n\}\n\n", "")
        sub(r"__device__ __forceinline__ void cp_async_wait_all\(\) \{.*?"
            r"\n\}\n\n", "")
    return _host_source(src)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel sources on the host")
    d = tmp_path_factory.mktemp("p1_replay")
    (d / "shim.h").write_text(SHIM)
    (d / "p1_shim.h").write_text(P1_SHIM)
    objs = []
    for name in ("prefix_rebuild.cu", "dc_totals.cu"):
        src = d / (name[:-3] + ".cc")
        src.write_text(_p1_host_source((CSRC / name).read_text()))
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
    lib.jdt_prefix_rebuild.argtypes = [p, p, q, p, p, q, p, p]
    lib.jdt_prefix_rebuild.restype = i
    lib.jdt_dc_totals.argtypes = [p, q, i, i, i, p, p, p, q, p]
    lib.jdt_dc_totals.restype = i
    lib.jdt_dc_totals_status_words.argtypes = [i, i]
    lib.jdt_dc_totals_status_words.restype = q
    lib.replay_config.argtypes = [ctypes.c_uint, i, i]
    return lib


def replayed_p1(lib, dc, ac, resid_idx, resid_vals, wave: int):
    """P1 through the replayed kernels with the wrapper's own checks and
    launches (`_check_p1`, `_p1_launch`), its output poisoned first: the
    flat int16 stores."""
    dc = dc.reshape(-1, dc.shape[-1])
    prefix._check_p1(dc, ac, resid_idx, resid_vals)
    out = torch.full((dc.numel() * 64,), POISON, dtype=torch.int16)
    lib.replay_config(wave, 0x5A + wave, 0)
    assert prefix._p1_launch(lib, dc, ac, resid_idx, resid_vals, out,
                             None) == 0
    return out


def _check_p1(lib, dc, ac, resid_idx, resid_vals, waves=(1, 3)):
    (want,) = prefix_stores_plain(whole_geometry(dc.shape[-1]), dc, ac,
                                  resid_idx, resid_vals)
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


@pytest.mark.parametrize("wave", [1, 2, 3, 4])
def test_replayed_p1_residuals_cross_tiles_of_other_ctas(lib, wave):
    """Eleven 256-block stretches (21 tiles, the last ragged), the CTAs
    of each launch in waves of 1 to 4; the residuals, in their own launch,
    land in any CTA's tile, with duplicates on both halves of words whose
    base values are nonzero, and a DC array off its 16-byte boundary for
    the element loads."""
    blocks = 10 * 256 + 77
    dc, ac, _idx, _vals = _tensors(p1_case(1, blocks, 0, seed=11))
    rng = np.random.default_rng(wave)
    rows = rng.integers(0, blocks, 3000)
    pos = rng.choice(np.flatnonzero((np.asarray(_ZIGZAG_OF_NATURAL)
                                     < PREFIX_K)), 3000)
    pos[::3] = rng.integers(0, 64, 1000)
    idx = torch.from_numpy((rows * 64 + pos).astype(np.int32))
    idx = torch.cat([idx, idx[:500], idx[:500] - blocks * 64])
    vals = torch.from_numpy(rng.integers(-32768, 32768, idx.numel(),
                                         dtype=np.int16))
    _check_p1(lib, dc, ac, idx, vals, waves=(wave,))
    raw = torch.zeros(blocks + 8, dtype=torch.int16)
    off = (1 - raw.data_ptr() // 2) % 8
    shifted = raw[off:off + blocks]
    shifted.copy_(dc.reshape(-1))
    assert shifted.data_ptr() % 16
    _check_p1(lib, shifted.view(1, blocks), ac, idx, vals, waves=(wave,))


def test_p1_prefix_tables_match_the_staging_zigzag_table():
    """`kNaturalOfZigzag` (where each of the 16 prefix slots lands) read
    from the .cu against the staging's zigzag table."""
    src = (CSRC / "prefix_rebuild.cu").read_text()
    table = re.search(r"kNaturalOfZigzag\[kPrefix\] = \{(.*?)\};", src,
                      re.S)[1]
    natural = [int(v) for v in table.replace("\n", " ").split(",")]
    assert [int(_ZIGZAG_OF_NATURAL[n]) for n in natural] == \
        list(range(PREFIX_K))


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
    """Three tower_420 merged as `_group_wires` merges a prefix group
    (`_prefix_wire`), put to the device off any graph: the residuals
    offset image by image, the padding at the sink."""
    staged = [stage_host(fixture("tower_420.jpg")) for _ in range(3)]
    with DeviceStreamDecoder(device="cpu", host_threads=1,
                             interchange="prefix") as dec:
        wires = dec._put_recorded(port_stream._prefix_wire(staged, 3))
    _check_p1(lib, *(w.contiguous() for w in wires))


def replayed_d1(lib, nat, plan, wave: int):
    """`dc_totals` through the replayed kernel with the wrapper's own
    checks, status count and launch (`_d1_prepare`, `_d1_launch`), the
    output poisoned and the status words past the launch's too; checks
    that the counter and the accumulators are 0 again and the words past
    them untouched."""
    out, meta, words = assemble._d1_prepare(lib, nat, plan)
    out.fill_(-0x5A5A5A5A5A5A5A5A)
    status = torch.from_numpy(np.random.default_rng(words).integers(
        -2 ** 62, 2 ** 62, 1 + words + 3))
    status[:1 + words] = 0
    before = status.clone()
    lib.replay_config(wave, 0x5A + wave, 0)
    assert assemble._d1_launch(lib, nat, plan, out, meta, status, None) == 0
    assert torch.equal(status, before), \
        "the accumulators must be 0 after the launch, the rest untouched"
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
    sums every block alike; large_420's 80,640 blocks: 315 CTAs an
    image), 1 and 3 images of full-range DC values, CTAs in waves of 1
    and 3."""
    (st,) = jt.stage_host_bits(fixture(name)).scans
    plan = st.scan.plan
    assert plan.structured is not None
    for images in (1, 3):
        _check_d1(lib, _seeded_nat(plan, images, len(name) + images), plan)


@pytest.mark.parametrize("name,stripes", [("large_420.jpg", 4),
                                          ("stripe_420.jpg", 8)])
def test_replayed_d1_on_stripe_plans(lib, name, stripes):
    """The stripe plans of large_420 at 4 (20,736 blocks: 81 CTAs an
    image) and stripe_420 at 8, two images of a DP shard; the int64 sums
    keep their high bits against the plain version's."""
    scan = jt.stage_host_bits(fixture(name)).scans[0].scan
    plan = split_anchored_stripes(scan, stripes).plan
    assert plan.n_blocks == 20736 or name != "large_420.jpg"
    _check_d1(lib, _seeded_nat(plan, 2, stripes), plan)


@pytest.mark.parametrize("images", [1, 2, 3])
def test_replayed_d1_ragged_last_cta(lib, images):
    """small_422's plan (a block count that leaves its last 256-block CTA
    ragged) over 1 to 3 images: the CTAs of one image never add another
    image's blocks."""
    (st,) = jt.stage_host_bits(fixture("small_422.jpg")).scans
    plan = st.scan.plan
    assert plan.n_blocks % 256 and plan.n_blocks > 256
    _check_d1(lib, _seeded_nat(plan, images, 40 + images), plan)


def test_replayed_d1_status_words(lib):
    """The status words D1 needs come from the kernel's own count
    (`jdt_dc_totals_status_words`, through `_d1_prepare`): one
    accumulator per (image, component); a buffer one word short is
    refused."""
    (st,) = jt.stage_host_bits(fixture("tower_420.jpg")).scans
    plan = st.scan.plan
    _n_mcus, specs = plan.structured
    for images in (1, 3, 700):
        assert lib.jdt_dc_totals_status_words(images, len(specs)) \
            == images * len(specs)
    nat = _seeded_nat(plan, 3, 0)
    out, meta, words = assemble._d1_prepare(lib, nat, plan)
    assert words == 3 * len(specs)
    status = torch.zeros(words, dtype=torch.int64)    # word 0, words - 1
    assert assemble._d1_launch(lib, nat, plan, out, meta, status, None) == 1


def test_replayed_d1_single_image_view(lib):
    """nat of one image, [n_blocks, 64], as `dc_totals` also takes it."""
    (st,) = jt.stage_host_bits(fixture("tower_420.jpg")).scans
    plan = st.scan.plan
    nat = _seeded_nat(plan, 1, 0)
    got = replayed_d1(lib, nat, plan, 3)
    assert torch.equal(got[0], dc_totals_plain(nat[0], plan))

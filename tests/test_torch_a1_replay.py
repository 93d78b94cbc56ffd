"""Kernels A1 (`csrc/assemble.cu`) and U1 (`csrc/unpack_delta.cu`) replayed
on the CPU from their own sources: each .cu is compiled by the host's g++
(C++20) with a small shim for the CUDA it uses (`threadIdx`, `__shared__`,
`uint4`, the warp shuffles and `__ballot_sync`, `atomicAdd`, `atomicExch`
and `atomicCAS`, `__constant__`, `__threadfence`, `__ldcg` and `__stcg`,
the loads and stores of the status words (A1's acquire and release, U1's
relaxed), `__nanosleep`), and each launch is run with every thread of a
CTA on a host thread of its own: `__syncthreads()` a `std::barrier` of the
CTA's threads, a shuffle an exchange through memory between two barriers
of the warp's 32 threads. Both run the constants the card runs.

The CTAs of a launch run in waves: a wave of 1 runs them one after
another, in the order the kernel's tile counter hands out the tiles; a
wave of 3 runs three at a time, so a CTA looks back at predecessors that
have published only their aggregate, or nothing yet, and waits. The
status buffer is poisoned with words of other epochs (aggregates and
prefixes with seeded values), shared memory with a poison byte at each
CTA's start and the output with a poison value, so a stale word read as
valid, an entry or row left unwritten or a shared value read before it is
written changes the result. After each launch the tile counter is 0 again
and every tile's status (U1: both of its words) is this epoch's inclusive
prefix; a U1 wire of one tile leaves the buffer as it was. U1 also runs
with one word of every tile's pair stored 2 ms after the other, so a CTA
meets a predecessor with one word of this launch and one of another.

Tolerance 0 against the plain versions (`assemble_nat_plain`,
`unpack_delta_plain`) over `torch_inputs.A1_CASES` (padded grids, restart
segments across tiles, sequences of 36 tiles, groups, carries with high
bits set, general maps), every fixture plan through both branches, and
U1 over wires of 0 to 5 of its tiles of `U1_TILE` entries (each tile edge,
a ragged and a full last tile, a wire off 16 bytes) with every bit
pattern, the fixtures' real wires and merged group wires of 3 tower_420
and of at least 4 tiles of large_420. This checks the kernels' tile
arithmetic and look-back, not the card: the card runs the same sources in
`tests/test_torch_cuda.py` and `chip_smoke.py` phase 25.

The epoch on the card (the launches a CUDA graph captures and replays,
`_build.DeviceEpochs`): the wrapper passes epoch 0 and each kernel takes
its epoch from word 0 of the buffer (its high 32 bits), and the last CTA
stores the next one there with the counter 0. Many launches in a row on
one buffer, never cleared, each on new seeded inputs of one shape, CTAs in
waves of 1 and 3, every launch bit-equal to plain and leaving word 0 the
next epoch with the counter 0 and every status word this launch's
prefix; A1 on a sequence of several tiles and U1 on a wire of several
tiles; and a run across the end of the epochs (2^32 for A1, 2^30 for U1),
from a buffer whose word 0 is set two launches below it and whose words
hold the launch before's epoch.
"""

import copy
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jpeg_decoder_tpu_torch as jt
from jpeg_decoder_tpu_torch.entropy import assemble
from jpeg_decoder_tpu_torch.entropy.assemble import (A1_ROWS, GeneralMaps,
                                                     assemble_nat_plain)
from jpeg_decoder_tpu_torch.entropy import chunk_decode
from jpeg_decoder_tpu_torch.entropy.chunk_decode import (U1_TILE,
                                                         unpack_delta_plain)

from torch_inputs import A1_CASES, SMALL_FIXTURES, a1_case, fixture

CSRC = Path(assemble.__file__).resolve().parent.parent / "csrc"

SHIM = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 716 };
inline int cudaGetLastError() { return 0; }
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __constant__
struct Cta {
  explicit Cta(int threads) : bar(threads), xch(threads) {
    for (int w = 0; w < threads / 32; ++w)
      warps.push_back(std::make_unique<std::barrier<>>(32));
  }
  std::barrier<> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<uint64_t> xch;
  alignas(16) unsigned char smem[48 * 1024];   // static shared memory
};
inline thread_local Cta* g_cta = nullptr;
inline thread_local dim3 threadIdx, blockIdx;
inline unsigned g_wave = 1;      // shared by the two kernels' sources
inline int g_poison = 0;
// A release store to a status word of index parity g_lag - 1 (1: even, 2:
// odd; 0: none) first sleeps, so a word lags the other of its tile's pair.
inline int g_lag = 0;
inline void lag_store(const void* p) {
  if (g_lag && ((reinterpret_cast<uintptr_t>(p) >> 3) & 1) == g_lag - 1u)
    std::this_thread::sleep_for(std::chrono::milliseconds(2));
}
#define __syncthreads() g_cta->bar.arrive_and_wait()
template <class T> T& shared_of() {
  static_assert(sizeof(T) <= sizeof(Cta::smem));
  return *reinterpret_cast<T*>(g_cta->smem);
}
// A warp's lanes trade values through memory between two barriers of its
// 32 threads; every lane of the warp reaches each shuffle, as on the card.
template <class T> T warp_exchange(T v, int src) {
  const int t = threadIdx.x, w = t >> 5;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  g_cta->xch[t] = bits;
  g_cta->warps[w]->arrive_and_wait();
  const uint64_t got = g_cta->xch[(w << 5) + src];
  g_cta->warps[w]->arrive_and_wait();
  T r;
  std::memcpy(&r, &got, sizeof(T));
  return r;
}
template <class T> T __shfl_up_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x & 31;
  return warp_exchange(v, lane >= d ? lane - d : lane);
}
template <class T> T __shfl_sync(unsigned, T v, int src) {
  return warp_exchange(v, src & 31);
}
template <class T> T __shfl_xor_sync(unsigned, T v, int o) {
  return warp_exchange(v, static_cast<int>(threadIdx.x & 31) ^ o);
}
inline unsigned __ballot_sync(unsigned, bool p) {
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    m |= (warp_exchange<unsigned>(p, i) ? 1u : 0u) << i;
  return m;
}
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline unsigned atomicExch(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).exchange(v);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline unsigned long long atomicExch(unsigned long long* p,
                                     unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).exchange(v);
}
// The old value, as on the card: `cmp` keeps it where the exchange fails.
inline unsigned atomicCAS(unsigned* p, unsigned cmp, unsigned v) {
  std::atomic_ref<unsigned>(*p).compare_exchange_strong(cmp, v);
  return cmp;
}
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
template <class T> void __stcg(T* p, T v) {
  std::atomic_ref<T>(*p).store(v, std::memory_order_relaxed);
}
template <class T> T __ldcg(const T* p) {
  return std::atomic_ref<T>(*const_cast<T*>(p)).load(
      std::memory_order_relaxed);
}
// CTAs in waves of g_wave, each of its threads on a host thread: a wave of
// 1 runs them one after another, in ticket order.
template <class K, class... A>
void replay(K kernel, unsigned grid, int threads, A... args) {
  if (grid == 0) return;
  const unsigned wave = std::min(g_wave, grid);
  std::vector<std::unique_ptr<Cta>> ctas;
  for (unsigned i = 0; i < wave; ++i)
    ctas.push_back(std::make_unique<Cta>(threads));
  std::barrier<> all(static_cast<std::ptrdiff_t>(wave) * threads);
  std::vector<std::thread> pool;
  for (unsigned i = 0; i < wave; ++i)
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, i, t] {
        g_cta = ctas[i].get();
        threadIdx = dim3(t);
        for (unsigned b0 = 0; b0 < grid; b0 += wave) {
          if (t == 0) std::memset(g_cta->smem, g_poison, sizeof(g_cta->smem));
          all.arrive_and_wait();
          if (b0 + i < grid) {
            blockIdx = dim3(b0 + i);
            kernel(args...);
          }
          all.arrive_and_wait();
        }
      });
  for (auto& th : pool) th.join();
}
"""

CONFIG = r"""
#include "shim.h"
extern "C" void replay_config(unsigned wave, int poison, int lag) {
  g_wave = wave;
  g_poison = poison;
  g_lag = lag;
}
"""


def _host_source(src: str) -> str:
    """A .cu with the shim in place of CUDA's runtime header, its shared
    memory per CTA, its status words' accesses (A1's acquire loads and
    release stores, U1's relaxed ones) atomic_ref ones of the same order,
    and its launches replayed."""
    def sub(pattern, repl, many=False):
        nonlocal src
        src, n = re.subn(pattern, repl, src, flags=re.S)
        assert n == 1 or (many and n > 1), pattern

    sub(r"#include <cuda_runtime.h>", '#include "shim.h"')
    sub(r"__shared__ Smem sm;", "Smem& sm = shared_of<Smem>();")
    sub(r"(\w+)<<<(.*?), kThreads, 0,\s*static_cast<cudaStream_t>\(stream\)"
        r">>>\(", r"replay(\1, \2, kThreads, ", many=True)
    for load, store, load_order, store_order in (
            ("load_acquire", "store_release", "acquire", "release"),
            ("load_relaxed", "store_relaxed", "relaxed", "relaxed")):
        if load not in src:
            continue
        sub(rf"__device__ __forceinline__ unsigned long long {load}\("
            r".*?\n\}\n",
            f"inline unsigned long long {load}(const unsigned long long* p) "
            "{ return std::atomic_ref<unsigned long long>(*const_cast<"
            "unsigned long long*>(p)).load(std::memory_order_"
            f"{load_order}); }}\n")
        sub(rf"__device__ __forceinline__ void {store}\(" r".*?\n\}\n",
            f"inline void {store}(unsigned long long* p, unsigned long long "
            "v) { lag_store(p); std::atomic_ref<unsigned long long>(*p)"
            f".store(v, std::memory_order_{store_order}); }}\n")
    assert "asm" not in src
    return src


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel sources on the host")
    d = tmp_path_factory.mktemp("a1_replay")
    (d / "shim.h").write_text(SHIM)
    objs = []
    for name in ("assemble.cu", "unpack_delta.cu"):
        src = d / (name[:-3] + ".cc")
        src.write_text(_host_source((CSRC / name).read_text()))
        objs.append(str(src))
    (d / "config.cc").write_text(CONFIG)
    objs.append(str(d / "config.cc"))
    res = subprocess.run([gxx, "-O1", "-std=c++20", "-shared", "-fPIC",
                          "-pthread", "-Wno-unknown-pragmas", "-I", str(d),
                          "-o", str(d / "liba1.so"), *objs],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lib = ctypes.CDLL(str(d / "liba1.so"))
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.jdt_assemble.argtypes = [p, q, i, i, p, i, p, p, q, q, p, p, q,
                                 ctypes.c_uint, p]
    lib.jdt_assemble.restype = i
    lib.jdt_unpack_delta.argtypes = [p, q, p, p, p, q, ctypes.c_uint, p]
    lib.jdt_unpack_delta.restype = i
    lib.replay_config.argtypes = [ctypes.c_uint, i, i]
    return lib


EPOCH = 7


def replayed_a1(lib, nat, plan, maps, carry, wave: int, seed: int):
    """`assemble_nat` through the replayed kernel, with the wrapper's own
    argument marshalling (`_a1_prepare`, `_a1_launch`), the status buffer
    poisoned with other epochs' words; checks the counter and the statuses
    the launch leaves."""
    layout, out, stores, carry_args = assemble._a1_prepare(nat, plan, maps,
                                                           carry)
    out.fill_(-23131)                                      # 0xA5A5
    tiles = nat.shape[0] * layout.data_tiles
    rng = np.random.default_rng(seed)
    stale = (rng.choice([EPOCH - 1, EPOCH + 1, EPOCH << 8], tiles + 1)
             << 32 | rng.integers(1, 3, tiles + 1) << 16
             | rng.integers(0, 1 << 16, tiles + 1))
    status = torch.from_numpy(stale.astype(np.int64))
    status[0] = 0                                          # the counter
    lib.replay_config(wave, 0x5A + wave, 0)
    err = assemble._a1_launch(lib, nat, plan, layout, out, carry_args,
                              status, EPOCH, None)
    assert err == 0
    assert int(status[0]) == 0, "the counter must be 0 after the launch"
    words = status[1:tiles + 1]
    assert torch.equal(words >> 32, torch.full_like(words, EPOCH))
    assert torch.equal(words >> 16 & 3, torch.full_like(words, 2))
    return stores


def _check(lib, nat, plan, maps, carry, waves=(1, 3)):
    want = assemble_nat_plain(nat, plan, maps, carry)
    for wave in waves:
        got = replayed_a1(lib, nat, plan, maps, carry, wave, seed=wave)
        assert len(got) == len(want)
        for c, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape and torch.equal(g, w), (wave, c)


@pytest.mark.parametrize("case", A1_CASES, ids=[c[0] for c in A1_CASES])
def test_replayed_a1_bit_equal_to_plain(lib, case):
    plan, nat, carry = a1_case(case)
    maps = None if plan.structured is not None else GeneralMaps(plan, "cpu")
    nat = torch.from_numpy(nat)
    carry = None if carry is None else torch.from_numpy(carry)
    _check(lib, nat, plan, maps, carry)
    if carry is not None:       # one value per component, every image
        _check(lib, nat, plan, maps, carry[:, 0].clone(), waves=(1,))


@pytest.mark.parametrize("branch", ["structured", "general"])
@pytest.mark.parametrize("name", SMALL_FIXTURES + ("tower_420.jpg",))
def test_replayed_a1_fixture_plans_both_branches(lib, name, branch):
    """Every fixture's plan (small_dri restart-segmented), both branches
    (general: a copy of the plan without its closed form), seeded nat of
    two images, with a carry."""
    (st,) = jt.stage_host_bits(fixture(name)).scans
    plan = st.scan.plan
    maps = None
    if branch == "general":
        plan = copy.copy(plan)
        plan.structured = None
        maps = GeneralMaps(plan, "cpu")
    rng = np.random.default_rng(len(name))
    nat = torch.from_numpy(rng.integers(-32768, 32768, (2, plan.n_blocks, 64),
                                        dtype=np.int16))
    carry = torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, (plan.ncomp, 2)))
    _check(lib, nat, plan, maps, carry, waves=(1,))


def test_replayed_a1_of_a_stripe_carry_view(lib):
    """The carry as the stripes pass it: `carry.T` of [images, ncomp], a
    view with strides (1, ncomp)."""
    plan, nat, _carry = a1_case(A1_CASES[2])
    carry = torch.from_numpy(np.random.default_rng(3).integers(
        -2 ** 62, 2 ** 62, (nat.shape[0], plan.ncomp))).T
    _check(lib, torch.from_numpy(nat), plan, None, carry, waves=(1,))


def _stale_words(rng, count: int) -> np.ndarray:
    """U1 status words of other launches: epochs near this one's, one
    that differs only in bit 29 and one far off, flag A or P, any value."""
    epochs = rng.choice(np.array([EPOCH - 1, EPOCH + 1, EPOCH | 1 << 29,
                                  EPOCH << 8], np.uint64), count)
    return (epochs << np.uint64(34)
            | rng.integers(1, 3, count, dtype=np.uint64) << np.uint64(32)
            | rng.integers(0, 1 << 32, count, dtype=np.uint64)).view(np.int64)


def replayed_u1(lib, dm: torch.Tensor, wave: int = 1, lag: int = 0):
    """`unpack_delta` through the replayed kernel, with the wrapper's own
    allocation and launch (`_u1_outputs`, `_u1_launch`) and a status
    buffer of other launches' words, the counter 0 (more than one tile)
    or not (one tile: the kernel must not touch the buffer); checks the
    counter and the statuses the launch leaves: each tile's two words this
    epoch's inclusive prefixes of its sums."""
    n = dm.numel()
    tiles = -(-n // U1_TILE)
    ab, base = chunk_decode._u1_outputs(dm)
    ab.fill_(-1515870811)                                     # 0xA5A5A5A5
    base.fill_(-1515870811)
    status = torch.from_numpy(_stale_words(np.random.default_rng(n + wave),
                                           2 * tiles + 3))
    status[0] = 0 if tiles > 1 else 12345                     # the counter
    before = status.clone()
    lib.replay_config(wave, 0x5A + wave, lag)
    assert chunk_decode._u1_launch(lib, dm, ab, base, status, EPOCH,
                                   None) == 0
    if tiles <= 1:
        assert torch.equal(status, before), "one tile touched the status"
        return ab, base
    assert int(status[0]) == 0, "the counter must be 0 after the launch"
    words = status[1:2 * tiles + 1].view(tiles, 2)
    assert torch.equal(words >> 34, torch.full_like(words, EPOCH))
    assert torch.equal(words >> 32 & 3, torch.full_like(words, 2))
    last = torch.arange(tiles) * U1_TILE + U1_TILE - 1
    last[-1] = n - 1
    budget = (dm[last].to(torch.int64) >> 4) & 31
    want = torch.stack([ab[last].to(torch.int64) & 0xFFFFFFFF,
                        (base[last].to(torch.int64) + budget) & 0xFFFFFFFF],
                       1)
    assert torch.equal(words & 0xFFFFFFFF, want), "a tile's prefix"
    assert torch.equal(status[2 * tiles + 1:], before[2 * tiles + 1:])
    return ab, base


def _u1_sizes() -> list:
    """Wires of 0 to 5 tiles, around each tile edge (and the sizes PR 15's
    one-CTA kernel was checked at)."""
    t = U1_TILE
    return sorted({0, 1, 31, 4095, 4096, 4097, 9000, t - 1, t, t + 1,
                   2 * t - 3, 2 * t, 2 * t + 1, 4 * t + 3, 5 * t})


def _seeded_wire(n: int) -> torch.Tensor:
    rng = np.random.default_rng(n)
    return torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))


def _check_u1(lib, dm, waves=(1, 3), lag=0):
    want = unpack_delta_plain(dm)
    for wave in waves:
        got = replayed_u1(lib, dm, wave, lag)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), wave


@pytest.mark.parametrize("n", _u1_sizes())
def test_replayed_u1_bit_equal_to_plain(lib, n):
    """Every bit pattern of the wire word (the shifts must be logical; the
    sums wrap mod 2^32 as the plain version's narrowing does), on wires of
    one tile and of 2 to 5 tiles of U1_TILE entries, the last one ragged
    or full, their CTAs in ticket order and three at a time."""
    _check_u1(lib, _seeded_wire(n))


@pytest.mark.parametrize("lag", [1, 2])
def test_replayed_u1_when_one_word_of_a_pair_lags(lib, lag):
    """Three CTAs at a time while one status word of every tile (the ab
    word, then the base word) is stored 2 ms after its pair: a CTA meets
    predecessors with one word of this launch and one of another."""
    _check_u1(lib, _seeded_wire(4 * U1_TILE + 3), waves=(3,), lag=lag)


def test_replayed_u1_off_16_bytes(lib):
    """A wire that starts 4 bytes past a 16-byte boundary takes word loads
    and stores."""
    dm = _seeded_wire(2 * U1_TILE + 9)[1:]
    assert dm.data_ptr() % 16
    _check_u1(lib, dm)


def test_replayed_u1_on_real_and_merged_wires(lib):
    """The fixtures' delta wires, and groups' merged wires (tower_420 x 3,
    and large_420 merged over at least 4 tiles), as the stream ships
    them."""
    from jpeg_decoder_tpu_torch.models.stream import merge_scans

    names = SMALL_FIXTURES + ("tower_420.jpg", "large_420.jpg")
    wires = []
    for name in names:
        for st in jt.stage_host_bits(fixture(name)).scans:
            wires.append(st.dm)
    tower = jt.stage_host_bits(fixture("tower_420.jpg")).scans[0]
    large = jt.stage_host_bits(fixture("large_420.jpg")).scans[0]
    groups = [[tower] * 3,
              [large] * -(-4 * U1_TILE // large.dm.size)]
    for group in groups:
        (_words, dm), _s_max, _n_blocks = merge_scans(group)
        wires.append(dm)
    assert wires[-1].size >= 4 * U1_TILE
    for dm in wires:
        _check_u1(lib, torch.from_numpy(np.ascontiguousarray(dm)),
                  waves=(1, 3) if dm.size > U1_TILE else (1,))


A1_EPOCHS = 1 << 32      # A1's device epochs run mod this
U1_EPOCHS = 1 << 30      # U1's


def _signed(w: int) -> int:
    """A 64-bit word as the int64 a buffer stores."""
    return w - (1 << 64) if w >= 1 << 63 else w


def _word0(epoch: int) -> int:
    """Word 0 of a device-epoch buffer holding `epoch`, counter 0."""
    return _signed(epoch << 32)


def device_epoch_a1(lib, nat, plan, status, wave: int, epoch: int):
    """One A1 launch on `status` with no host epoch (the card's), its
    counter and words checked: the launch took `epoch` and left the next."""
    layout, out, stores, carry_args = assemble._a1_prepare(nat, plan, None,
                                                           None)
    out.fill_(-23131)
    tiles = nat.shape[0] * layout.data_tiles
    lib.replay_config(wave, 0x5A + wave, 0)
    assert assemble._a1_launch(lib, nat, plan, layout, out, carry_args,
                               status, 0, None) == 0
    assert int(status[0]) == _word0((epoch + 1) % A1_EPOCHS)
    words = status[1:tiles + 1]
    assert torch.equal((words >> 32) & 0xFFFFFFFF,
                       torch.full_like(words, epoch))
    assert torch.equal(words >> 16 & 3, torch.full_like(words, 2))
    return stores


@pytest.mark.parametrize("start", [0, A1_EPOCHS - 2],
                         ids=["from 0", "across the wrap"])
def test_replayed_a1_device_epochs_in_a_row(lib, start):
    """A1 launched again and again on one status buffer with no host epoch
    and no clearing between launches, on new seeded nat of one plan each
    time (small_444's: three components of two tiles, two images, 12
    tiles): every launch bit-equal to plain. From a zeroed buffer (as
    `DeviceEpochs` makes it), and from word 0 two launches below the end
    of the epochs with every word the launch before's, so the run crosses
    the wrap."""
    (st,) = jt.stage_host_bits(fixture("small_444.jpg")).scans
    plan = st.scan.plan
    shape = (2, plan.n_blocks, 64)
    layout = assemble._a1_prepare(torch.zeros(shape, dtype=torch.int16),
                                  plan, None, None)[0]
    tiles = shape[0] * layout.data_tiles
    assert tiles == 12 and all(-(-r // A1_ROWS) == 2 for r in layout.rows)
    status = torch.zeros(tiles + 1, dtype=torch.int64)
    if start:
        prev = start - 1
        status[1:] = _signed((prev << 32) | (2 << 16) | 0x1234)
        status[0] = _word0(start)
    rng = np.random.default_rng(start % 97)
    for k in range(4 if not start else 3):
        nat = torch.from_numpy(rng.integers(-32768, 32768, shape,
                                            dtype=np.int16))
        got = device_epoch_a1(lib, nat, plan, status, 1 + 2 * (k % 2),
                              (start + k) % A1_EPOCHS)
        want = assemble_nat_plain(nat, plan)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), k


def device_epoch_u1(lib, dm, status, wave: int, epoch: int):
    """One U1 launch on `status` with no host epoch, its word 0 and its
    tiles' words checked."""
    n = dm.numel()
    tiles = -(-n // U1_TILE)
    ab, base = chunk_decode._u1_outputs(dm)
    ab.fill_(-1515870811)
    base.fill_(-1515870811)
    lib.replay_config(wave, 0x5A + wave, 0)
    assert chunk_decode._u1_launch(lib, dm, ab, base, status, 0, None) == 0
    assert int(status[0]) == _word0((epoch + 1) % U1_EPOCHS)
    words = status[1:2 * tiles + 1]
    assert torch.equal(words >> 34 & (U1_EPOCHS - 1),
                       torch.full_like(words, epoch))
    assert torch.equal(words >> 32 & 3, torch.full_like(words, 2))
    return ab, base


@pytest.mark.parametrize("start", [0, U1_EPOCHS - 2],
                         ids=["from 0", "across the wrap"])
def test_replayed_u1_device_epochs_in_a_row(lib, start):
    """U1 on a wire of 2 tiles and a ragged third, launched again and
    again on one status buffer with no host epoch and no clearing, each
    launch on a new seeded wire: every launch bit-equal to plain, from a
    zeroed buffer and across the end of U1's 2^30 epochs (word 0 two
    launches below it, every word the launch before's)."""
    n = 2 * U1_TILE + 777
    tiles = -(-n // U1_TILE)
    status = torch.zeros(2 * tiles + 1, dtype=torch.int64)
    if start:
        prev = start - 1
        status[1:] = _signed((prev << 34) | (2 << 32) | 0x1234)
        status[0] = _word0(start)
    rng = np.random.default_rng(start % 89)
    for k in range(4 if not start else 3):
        dm = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                              .astype(np.uint32).view(np.int32))
        got = device_epoch_u1(lib, dm, status, 1 + 2 * (k % 2),
                              (start + k) % U1_EPOCHS)
        assert all(torch.equal(g, w)
                   for g, w in zip(got, unpack_delta_plain(dm))), k

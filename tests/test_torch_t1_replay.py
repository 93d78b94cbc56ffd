"""Kernel T1's own source (`csrc/interleaved_tail.cu`) replayed on the CPU:
the .cu is compiled by the host's g++ (C++20) with a small shim for the
CUDA it uses (`blockIdx`/`threadIdx`, `__shared__`, `__ldg`,
`__byte_perm`, `__vimin_s32_relu`, `uint4`), its `cp.async` copies made
plain copies, and each launch run CTA by CTA with every thread of the CTA
on a host thread of its own, `__syncthreads()` and `__syncwarp()` a
`std::barrier` of them. The staged tiles are filled with a poison byte at
each CTA's start, and every call runs twice, with two poison bytes, so a
tap read from a row or column the tile never staged changes the result.

Tolerance 0 against the plain version `interleaved_tail_plain` over
`torch_inputs.T1_CASES` (interleaved and planar), the stripes of
`test_torch_interleaved_tail.STRIPES` through `make_stripe_pipeline`
(row0 off the tiles, padding stripes whose far row lies below their
near rows), stripes called directly at odd row offsets with halos, and
slabs that start at an odd byte offset (the single-byte loads) into row
pitches that are not multiples of 16 (the narrow stores). This checks the
kernel's tile arithmetic, not the card: the card runs the same source in
`tests/test_torch_cuda.py` and `chip_smoke.py` phase 24.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu_torch.ops import kernels
from jpeg_decoder_tpu_torch.ops.kernels import (T1_MODES, T1_TRANSFORMS,
                                                TailStripe, _t1_output,
                                                interleaved_tail_plain)
from jpeg_decoder_tpu_torch.parallel import make_mesh, stripes
from jpeg_decoder_tpu_torch.parallel.stripes import (_pad_rows,
                                                     make_stripe_pipeline)

from test_torch_interleaved_tail import STRIPES
from torch_inputs import T1_CASES, T1_LAYOUTS, t1_args, t1_geometry, t1_pixels

CU = (Path(kernels.__file__).resolve().parent.parent / "csrc"
      / "interleaved_tail.cu")

SHIM = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 { uint32_t x, y, z, w; };
struct uint2 { uint32_t x, y; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long v = (static_cast<unsigned long long>(y) << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= static_cast<unsigned>((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF)
         << (8 * i);
  return r;
}
inline int __vimin_s32_relu(int a, int b) {
  const int m = a < b ? a : b;
  return m > 0 ? m : 0;
}
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
static thread_local dim3 blockIdx, threadIdx;
static std::barrier<>* g_barrier = nullptr;
static int g_poison = 0;
#define __global__
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __syncthreads() g_barrier->arrive_and_wait()
#define __syncwarp() g_barrier->arrive_and_wait()
template <class T> inline T __ldg(const T* p) { return *p; }
// Each thread of a CTA on a host thread of its own, the CTAs one after
// another; __syncthreads() (and __syncwarp(), which every thread of the
// kernel reaches alike) a barrier of the CTA's threads.
template <class K, class A>
void replay(K kernel, dim3 grid, const A& a, int threads) {
  std::barrier<> bar(threads);
  g_barrier = &bar;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      threadIdx = dim3(t);
      for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
          for (unsigned x = 0; x < grid.x; ++x) {
            blockIdx = dim3(x, y, z);
            kernel(a);
            bar.arrive_and_wait();
          }
    });
  for (auto& th : pool) th.join();
}
"""


def _host_source(src: str) -> str:
    """The .cu with the shim in place of CUDA's runtime header, the copies
    made at once and each launch replayed."""
    def sub(pattern, repl):
        nonlocal src
        src, n = re.subn(pattern, repl, src, flags=re.S)
        assert n == 1, pattern

    sub(r"#include <cuda_runtime.h>", '#include "shim.h"')
    sub(r"__device__ __forceinline__ void cp_async\(.*?\n\}\n",
        "inline void cp_async(uint8_t* dst, const uint8_t* src, int l) "
        "{ memcpy(dst, src, l == 3 ? 8 : 4); }\n")
    sub(r"__device__ __forceinline__ void cp_async_commit\(\) \{.*?\n\}\n",
        "inline void cp_async_commit() {}\n")
    sub(r"template <int kPending>\n__device__ __forceinline__ void "
        r"cp_async_wait\(\) \{.*?\n\}\n",
        "template <int kPending> void cp_async_wait() {}\n")
    sub(r"interleaved_tail_kernel<L, P, N><<<grid, kThreads, 0, stream>>>"
        r"\(a\);", "replay(interleaved_tail_kernel<L, P, N>, grid, a, "
        "kThreads);")
    sub(r"(__shared__ __align__\(16\) uint8_t smem\[N\]\[kTH \* kPitch\];)",
        r"\1\n  if (threadIdx.x == 0) memset(smem, g_poison, sizeof(smem));"
        r"\n  __syncthreads();")
    assert "asm" not in src
    return src + ('\nextern "C" void replay_poison(int p) '
                  '{ g_poison = p; }\n')


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel source on the host")
    d = tmp_path_factory.mktemp("t1_replay")
    (d / "shim.h").write_text(SHIM)
    (d / "t1.cc").write_text(_host_source(CU.read_text()))
    res = subprocess.run([gxx, "-O1", "-std=c++20", "-shared", "-fPIC",
                          "-pthread",
                          "-Wno-unknown-pragmas", "-I", str(d), "-o",
                          str(d / "libt1.so"), str(d / "t1.cc")],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lib = ctypes.CDLL(str(d / "libt1.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.jdt_interleaved_tail.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p]
    lib.jdt_interleaved_tail.restype = i
    return lib


def replayed(lib, pixels, comps, transform, out_h, out_w, planar=False,
             stripe=None):
    """`interleaved_tail` through the replayed kernel, with the wrapper's
    arguments (ops/kernels.py), held to the plain version under two
    poison bytes."""
    kernels._check_interleaved_tail(pixels, comps, transform, out_h, out_w,
                                    stripe)
    n = len(pixels)
    st = stripe if stripe is not None else TailStripe(0, (0,) * n,
                                                      (None,) * n)
    halos = [h for pair in st.halos
             for h in (pair if pair is not None else (None, None))]
    meta = []
    for px, comp, base, top, bot in zip(pixels, comps, st.bases, halos[::2],
                                        halos[1::2]):
        s, bw = px.shape[-1], comp.blocks_wide
        meta += [px.stride(0), 0 if top is None else top.stride(0),
                 0 if bot is None else bot.stride(0), bw, s,
                 px.shape[1] // bw * s, comp.size_width, comp.size_height,
                 T1_MODES.index(comp.upsampler_mode), comp.h_scale,
                 comp.v_scale, base]
    want = interleaved_tail_plain(pixels, comps, transform, out_h, out_w,
                                  planar, stripe)
    for poison in (0x5A, 0xC3):
        lib.replay_poison(poison)
        out, chans = _t1_output(pixels, transform, out_h, out_w, planar)
        out_meta = [v for ch in chans for v in ch] + [out.stride(0)]
        err = lib.jdt_interleaved_tail(
            (ctypes.c_void_p * n)(*[px.data_ptr() for px in pixels]),
            (ctypes.c_void_p * (2 * n))(
                *[0 if h is None else h.data_ptr() for h in halos]),
            (ctypes.c_longlong * len(meta))(*meta), n,
            T1_TRANSFORMS.index(None if transform is None
                                else transform.value),
            out_h, out_w, st.row0, pixels[0].shape[0], out.data_ptr(),
            (ctypes.c_longlong * len(out_meta))(*out_meta), None)
        assert err == 0
        assert out.shape == want.shape and torch.equal(out, want), poison
    return want


@pytest.mark.parametrize("case", T1_CASES,
                         ids=["-".join(map(str, c)) for c in T1_CASES])
def test_replayed_t1_bit_equal_to_plain(lib, case):
    layout, transform, h, w, scale, images = case
    geometry = t1_geometry(layout, h, w, scale, transform)
    pixels = t1_pixels(geometry, images, seed=7 * h + w)
    for planar in (False, True):
        replayed(lib, pixels, *t1_args(geometry), planar=planar)


@pytest.mark.parametrize("case", STRIPES,
                         ids=["-".join(map(str, c)) for c in STRIPES])
def test_replayed_t1_stripes_bit_equal_to_plain(lib, monkeypatch, case):
    layout, transform, h, w, n = case
    calls = []

    def spy(pixels, *args, **kw):
        calls.append(kw["stripe"].row0)
        return replayed(lib, pixels, *args, **kw)

    monkeypatch.setattr(stripes, "interleaved_tail", spy)
    geometry = t1_geometry(layout, h, w, 8, transform)
    mcu_rows = -(-h // (8 * max(f[1] for f in T1_LAYOUTS[layout])))
    rng = np.random.default_rng(h * w)
    stores = _pad_rows(geometry, [
        rng.integers(-60, 60, (c.blocks_wide * c.blocks_high, 64))
        .astype(np.int16) for c in geometry.components], mcu_rows, n, False)
    make_stripe_pipeline(geometry, mcu_rows, n, make_mesh(
        {"stripe": n}, ["cpu"] * n))(
        stores, tuple(np.full(64, 3, np.uint16) for _ in stores))
    assert len(calls) == n


# (layout, transform, row0, rows): stripes called directly, row0 at, off
# and across the kernel's 16-row tiles, odd, and past the image (200 rows:
# chroma 100) so that far rows fall below the near rows' block.
DIRECT = [(layout, transform, row0, rows)
          for layout, transform in (("420", "YCBCR"), ("440", "YCBCR"),
                                    ("g23", "YCBCR"), ("mixed4", "YCCK"))
          for row0, rows in ((0, 16), (5, 23), (33, 40), (2, 1), (231, 17))]


@pytest.mark.parametrize("case", DIRECT,
                         ids=["-".join(map(str, c)) for c in DIRECT])
def test_replayed_t1_direct_stripes_bit_equal_to_plain(lib, case):
    layout, transform, row0, rows = case
    geometry = t1_geometry(layout, 200, 70, 8, transform)
    rng = np.random.default_rng(row0 * 31 + rows)
    pixels, bases, halos = [], [], []
    for c in geometry.components:
        s, mode = c.dct_scale, c.upsampler_mode
        if mode in ("h1v2", "h2v2"):
            base = row0 // 2 // s * s
            need = -(-(row0 + rows) // 2) - base
            halos.append(tuple(torch.from_numpy(rng.integers(
                0, 256, (2, 1, c.blocks_wide * s), dtype=np.uint8))
                for _ in range(2)))
        elif mode == "generic":
            base = row0 // c.v_scale // s * s
            need = (row0 + rows - 1) // c.v_scale - base + 1
            halos.append(None)
        else:
            base, need = 0, rows
            halos.append(None)
        bases.append(base)
        pixels.append(torch.from_numpy(rng.integers(
            0, 256, (2, -(-max(need, 1) // s) * c.blocks_wide, s, s),
            dtype=np.uint8)))
    stripe = TailStripe(row0, tuple(bases), tuple(halos))
    for planar in (False, True):
        replayed(lib, pixels, geometry.components, geometry.transform, rows,
                 geometry.out_width, planar=planar, stripe=stripe)


@pytest.mark.parametrize("layout,transform", [
    ("420", "YCBCR"), ("422", "YCBCR"), ("444", "YCBCR"), ("gray", None),
    ("mixed4", "YCCK"), ("440", "RGB")])
@pytest.mark.parametrize("scale", [8, 4, 2, 1])
def test_replayed_t1_odd_slabs_bit_equal_to_plain(lib, layout, transform,
                                                  scale):
    geometry = t1_geometry(layout, 37, 145, scale, transform)
    odd = []
    for p in t1_pixels(geometry, 3, scale):
        flat = torch.zeros(p.numel() + 16, dtype=torch.uint8)
        odd.append(flat[3:3 + p.numel()].view(p.shape))
        odd[-1].copy_(p)
    for planar in (False, True):
        replayed(lib, odd, *t1_args(geometry), planar=planar)

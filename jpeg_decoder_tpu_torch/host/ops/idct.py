"""Copy of `jpeg_decoder_tpu/ops/idct.py` at commit 0c2d0ea, without the
jax matmul branch of the fast tier.

Batched dequantization + IDCT, bit-exact with the reference scalar kernels.

The reference IDCTs one 8x8 block at a time with a branchy scalar kernel
(`src/idct.rs:205-578`, stb_image-derived fixed point). On TPU
the same integer math is instead evaluated for *all* blocks of a component in
one batched, branch-free pass: every intermediate is an `[N, 8]` int32 lane
vector, which XLA maps straight onto the VPU. The reference's zero-column /
zero-row shortcuts are pure micro-optimizations — for an all-zero AC column the
full butterfly reduces to exactly the shortcut's value (the rounding terms
vanish under the >>10 / >>17 shifts) — so the batched full computation is
bit-identical to the scalar kernel, shortcut included.

All arithmetic wraps modulo 2^32 (numpy/XLA int32 semantics), matching the
reference's `Wrapping<i32>` hardening against malicious inputs
(`src/idct.rs:1-3`).

Scaled 4x4 / 2x2 / 1x1 kernels follow Dugad-Ahuja compressed-domain downscaling
exactly as the reference does (`src/idct.rs:454-565`).
"""

from __future__ import annotations

import functools

import numpy as np


def _f2f(x: float, bits: int = 12) -> int:
    """Fixed-point constant: trunc(f32(x) * 2^bits + 0.5), matching Rust's
    `(x * 4096.0 + 0.5) as i32` f32 arithmetic + truncation
    (`src/idct.rs:572-574`)."""
    return int(np.float32(np.float32(x) * np.float32(1 << bits)) + np.float32(0.5))

# stb constants, scaled by 2^12.
_C0_541 = _f2f(0.5411961)
_CM1_847 = _f2f(-1.847759065)
_C0_765 = _f2f(0.765366865)
_C1_175 = _f2f(1.175875602)
_C0_298 = _f2f(0.298631336)
_C2_053 = _f2f(2.053119869)
_C3_072 = _f2f(3.072711026)
_C1_501 = _f2f(1.501321110)
_CM0_899 = _f2f(-0.899976223)
_CM2_562 = _f2f(-2.562915447)
_CM1_961 = _f2f(-1.961570560)
_CM0_390 = _f2f(-0.390180644)

_X_SCALE_ROW = 65536 + (128 << 17)


def choose_idct_size(full_size, requested_size) -> int:
    """Pick the smallest IDCT scale in {1,2,4,8}/8 whose output covers the
    request in at least one axis (`src/idct.rs:14-28`)."""
    def scaled(length: int, scale: int) -> int:
        return (length * scale - 1) // 8 + 1

    for scale in (1, 2, 4):
        if (scaled(full_size.width, scale) >= requested_size.width
                or scaled(full_size.height, scale) >= requested_size.height):
            return scale
    return 8


def _kernel_x(xp, s0, s2, s4, s6, x_scale):
    """Even-index butterfly (`src/idct.rs:377-407`)."""
    p1 = (s2 + s6) * _C0_541
    t2 = p1 + s6 * _CM1_847
    t3 = p1 + s2 * _C0_765
    t0 = (s0 + s4) << 12
    t1 = (s0 - s4) << 12
    x0 = t0 + t3 + x_scale
    x3 = t0 - t3 + x_scale
    x1 = t1 + t2 + x_scale
    x2 = t1 - t2 + x_scale
    return x0, x1, x2, x3


def _kernel_t(xp, s1, s3, s5, s7):
    """Odd-index butterfly (`src/idct.rs:409-439`)."""
    t0, t1, t2, t3 = s7, s5, s3, s1
    p3 = t0 + t2
    p4 = t1 + t3
    p1 = t0 + t3
    p2 = t1 + t2
    p5 = (p3 + p4) * _C1_175

    t0 = t0 * _C0_298
    t1 = t1 * _C2_053
    t2 = t2 * _C3_072
    t3 = t3 * _C1_501

    p1 = p5 + p1 * _CM0_899
    p2 = p5 + p2 * _CM2_562
    p3 = p3 * _CM1_961
    p4 = p4 * _CM0_390

    t3 = t3 + p1 + p4
    t2 = t2 + p2 + p3
    t1 = t1 + p2 + p4
    t0 = t0 + p1 + p3
    return t0, t1, t2, t3


def _clamp_u8(xp, v):
    """-128..127-biased value to 0..255 u8 (`src/idct.rs:567-570`)."""
    return xp.clip(v, 0, 255).astype(xp.uint8)


def _idct8x8(xp, s, coeff):
    """Full 8x8 dequantized IDCT; `s` is int32 [..., 8(row), 8(col)], `coeff`
    the raw (pre-dequantize) coefficients of the same shape."""
    i32 = xp.int32
    # Column pass (over rows axis -2): produces temp[row, col] >> 10.
    x0, x1, x2, x3 = _kernel_x(
        xp, s[..., 0, :], s[..., 2, :], s[..., 4, :], s[..., 6, :], i32(512))
    t0, t1, t2, t3 = _kernel_t(xp, s[..., 1, :], s[..., 3, :], s[..., 5, :], s[..., 7, :])
    temp = xp.stack([
        (x0 + t3) >> 10,
        (x1 + t2) >> 10,
        (x2 + t1) >> 10,
        (x3 + t0) >> 10,
        (x3 - t0) >> 10,
        (x2 - t1) >> 10,
        (x1 - t2) >> 10,
        (x0 - t3) >> 10,
    ], axis=-2)

    # Zero-AC-column shortcut (`src/idct.rs:279-296`). Not just
    # a speed trick: for |dequantized DC| >= 2^19 the shortcut's `dc << 2`
    # wraps differently than the full path's `((dc << 12) + 512) >> 10`
    # (reachable with 16-bit quantization tables), so it must be reproduced to
    # stay bit-exact with the reference. The row-pass shortcut needs no special
    # handling — it evaluates the identical expression as the full path.
    col_ac_zero = xp.all(coeff[..., 1:, :] == 0, axis=-2)  # [..., 8] per column
    dcterm = s[..., 0, :] << 2
    temp = xp.where(col_ac_zero[..., None, :], dcterm[..., None, :], temp)

    # Row pass (over cols axis -1), with the final round/bias scale folded in
    # (`src/idct.rs:327-368`).
    x0, x1, x2, x3 = _kernel_x(
        xp, temp[..., 0], temp[..., 2], temp[..., 4], temp[..., 6], i32(_X_SCALE_ROW))
    t0, t1, t2, t3 = _kernel_t(xp, temp[..., 1], temp[..., 3], temp[..., 5], temp[..., 7])
    out = xp.stack([
        (x0 + t3) >> 17,
        (x1 + t2) >> 17,
        (x2 + t1) >> 17,
        (x3 + t0) >> 17,
        (x3 - t0) >> 17,
        (x2 - t1) >> 17,
        (x1 - t2) >> 17,
        (x0 - t3) >> 17,
    ], axis=-1)
    return _clamp_u8(xp, out)


def _idct4x4(xp, s):
    """Dugad-Ahuja 4x4 reduced IDCT (`src/idct.rs:456-517`).
    `s` is int32 [..., 4(row), 4(col)] — the top-left coefficients."""
    i32 = xp.int32
    s0, s1, s2, s3 = s[..., 0, :], s[..., 1, :], s[..., 2, :], s[..., 3, :]
    x0 = (s0 + s2) << 2
    x2 = (s0 - s2) << 2
    p1 = (s1 + s3) * _C0_541
    t0 = (p1 + s3 * _CM1_847 + i32(512)) >> 10
    t2 = (p1 + s1 * _C0_765 + i32(512)) >> 10
    temp = xp.stack([x0 + t2, x2 + t0, x2 - t0, x0 - t2], axis=-2)  # [..., 4, 4]

    s0, s1, s2, s3 = temp[..., 0], temp[..., 1], temp[..., 2], temp[..., 3]
    x0 = (s0 + s2) << 12
    x2 = (s0 - s2) << 12
    p1 = (s1 + s3) * _C0_541
    t0 = p1 + s3 * _CM1_847
    t2 = p1 + s1 * _C0_765
    bias = i32((1 << 16) + (128 << 17))
    x0 = x0 + bias
    x2 = x2 + bias
    out = xp.stack([
        (x0 + t2) >> 17,
        (x2 + t0) >> 17,
        (x2 - t0) >> 17,
        (x0 - t2) >> 17,
    ], axis=-1)
    return _clamp_u8(xp, out)


def _idct2x2(xp, s):
    """Dugad-Ahuja 2x2 reduced IDCT (`src/idct.rs:519-553`).
    `s` is int32 [..., 2(row), 2(col)]."""
    i32 = xp.int32
    s00, s01 = s[..., 0, 0], s[..., 0, 1]
    s10, s11 = s[..., 1, 0], s[..., 1, 1]
    bias = i32((1 << 2) + (128 << 3))
    x0 = s00 + s10 + bias
    x2 = s00 - s10 + bias
    x1 = s01 + s11
    x3 = s01 - s11
    r0 = xp.stack([(x0 + x1) >> 3, (x0 - x1) >> 3], axis=-1)
    r1 = xp.stack([(x2 + x3) >> 3, (x2 - x3) >> 3], axis=-1)
    return _clamp_u8(xp, xp.stack([r0, r1], axis=-2))


def _idct1x1(xp, s00):
    """DC-only 1x1 (`src/idct.rs:555-565`). Rust's Wrapping<i32>
    division truncates toward zero; reproduce that for negative DC."""
    v = s00 + 1024  # 128 * 8
    q = xp.where(v >= 0, v >> 3, -((-v) >> 3))
    return _clamp_u8(xp, q)[..., None, None]


def dequantize_and_idct_blocks(coefficients, quantization_table, scale: int = 8, xp=np):
    """Dequantize + IDCT a batch of blocks.

    Args:
      coefficients: int16 [N, 64] natural-order coefficient blocks.
      quantization_table: uint16[64] natural-order (unzigzagged) table.
      scale: IDCT output size per block edge (8, 4, 2, or 1).
      xp: array namespace (numpy or jax.numpy).

    Returns uint8 [N, scale, scale].
    """
    c = xp.asarray(coefficients).astype(xp.int32).reshape(-1, 8, 8)
    q = xp.asarray(quantization_table).astype(xp.int32).reshape(8, 8)
    s = c * q  # wrapping dequantize (`src/idct.rs:449-452`)

    if scale == 8:
        return _idct8x8(xp, s, c)
    if scale == 4:
        return _idct4x4(xp, s[:, :4, :4])
    if scale == 2:
        return _idct2x2(xp, s[:, :2, :2])
    if scale == 1:
        return _idct1x1(xp, s[:, 0, 0])
    raise ValueError(f"Unsupported IDCT scale {scale}/8")


def _idct_basis_64() -> np.ndarray:
    """The 8x8 IDCT as one 64x64 linear map: vec(B F B^T) = (B (x) B) vec(F),
    row-major. B[y, v] = 0.5 C(v) cos((2y+1) v pi / 16) (A.3.3 of T.81).

    This is the MXU formulation: all blocks of a component become one
    [N, 64] x [64, 64] matmul instead of per-block butterflies on the VPU.
    """
    y = np.arange(8)
    v = np.arange(8)
    b = 0.5 * np.cos((2 * y[:, None] + 1) * v[None, :] * np.pi / 16)
    b[:, 0] *= 1.0 / np.sqrt(2.0)
    m = np.einsum("yv,xu->yxvu", b, b).reshape(64, 64)
    return m.astype(np.float32)


_IDCT_M64_T = _idct_basis_64().T.copy()  # [64(coef), 64(pixel)]


def _scaled_float_kernel(s: np.ndarray, scale: int) -> np.ndarray:
    """Float mirror of the Dugad-Ahuja integer kernels (_idct4x4/_idct2x2/
    _idct1x1) with the fixed-point truncations replaced by exact division and
    the +128 bias/clamp epilogue left out. Exactly linear in `s`, so probing
    it with unit coefficients yields the scaled IDCT as one matmul basis.

    s: float64 [B, scale, scale] dequantized top-left coefficients.
    Returns float64 [B, scale, scale] pixels (pre-bias)."""
    if scale == 1:
        return s / 8.0
    if scale == 2:
        s00, s01 = s[:, 0, 0], s[:, 0, 1]
        s10, s11 = s[:, 1, 0], s[:, 1, 1]
        x0, x2 = s00 + s10, s00 - s10
        x1, x3 = s01 + s11, s01 - s11
        r0 = np.stack([x0 + x1, x0 - x1], axis=-1)
        r1 = np.stack([x2 + x3, x2 - x3], axis=-1)
        return np.stack([r0, r1], axis=-2) / 8.0
    assert scale == 4, scale

    def butterfly(s0, s1, s2, s3, up: float, down: float):
        x0 = (s0 + s2) * up
        x2 = (s0 - s2) * up
        p1 = (s1 + s3) * _C0_541
        t0 = (p1 + s3 * _CM1_847) / down
        t2 = (p1 + s1 * _C0_765) / down
        return np.stack([x0 + t2, x2 + t0, x2 - t0, x0 - t2], axis=-2)

    # Column pass (`src/idct.rs:456-487`): <<2 with the
    # (+512)>>10 rounding removed; row pass (`:489-517`): <<12 then >>17.
    temp = butterfly(s[..., 0, :], s[..., 1, :], s[..., 2, :], s[..., 3, :],
                     4.0, 1024.0)
    out = butterfly(temp[..., 0], temp[..., 1], temp[..., 2], temp[..., 3],
                    4096.0, 1.0) / 131072.0
    return out.transpose(0, 2, 1)


@functools.lru_cache(maxsize=None)
def scaled_idct_basis(scale: int) -> np.ndarray:
    """The Dugad-Ahuja scaled IDCT as a [64(coef), scale*scale(px)] float32
    linear map (MXU formulation for the fast tier; the exact integer kernels
    above remain the bit-parity path). Coefficient rows outside the top-left
    scale x scale region are zero — the scaled kernels never read them
    (`src/idct.rs:449-452` dequantizes only `scale` rows)."""
    probes = np.zeros((scale * scale, scale, scale), np.float64)
    idx = np.arange(scale * scale)
    probes[idx, idx // scale, idx % scale] = 1.0
    px = _scaled_float_kernel(probes, scale).reshape(scale * scale, -1)
    m = np.zeros((64, scale * scale), np.float32)
    for v in range(scale):
        for u in range(scale):
            m[v * 8 + u] = px[v * scale + u].astype(np.float32)
    return m


def dequantize_and_idct_blocks_fast(coefficients, quantization_table, xp=np,
                                    scale: int = 8):
    """fp32 MXU IDCT ("fast" precision mode): bit-equivalence is NOT guaranteed
    but output stays within the reference reftest tolerance (<=3 vs golden) —
    the same contract as the reference's arch SIMD kernels, which are also not
    bit-identical to its scalar path (`src/arch/mod.rs:13-57`,
    CHANGELOG v0.2.2 note). Exact mode remains the default for parity.

    scale < 8 uses the scaled_idct_basis linearization of the Dugad-Ahuja
    kernels (worst |diff| vs the exact integer kernels = 1 on in-range
    content; int32-wrapping divergence on adversarial magnitudes, the same
    caveat as scale 8).

    Returns uint8 [N, scale, scale].
    """
    basis = _IDCT_M64_T if scale == 8 else scaled_idct_basis(scale)
    c = xp.asarray(coefficients).reshape(-1, 64).astype(xp.float32)
    q = xp.asarray(quantization_table).astype(xp.float32).reshape(1, 64)
    s = c * q
    y = s @ basis
    out = xp.clip(xp.floor(y + xp.float32(128.5)), 0, 255).astype(xp.uint8)
    return out.reshape(-1, scale, scale)


def blocks_to_plane(block_pixels, blocks_wide: int, blocks_high: int, xp=np):
    """Assemble [N, s, s] block pixels into a [blocks_high*s, blocks_wide*s] plane."""
    n, s, _ = block_pixels.shape
    assert n == blocks_wide * blocks_high
    return (
        block_pixels.reshape(blocks_high, blocks_wide, s, s)
        .transpose(0, 2, 1, 3)
        .reshape(blocks_high * s, blocks_wide * s)
    )

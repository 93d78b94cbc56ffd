"""Copy of `jpeg_decoder_tpu/ops/predictors.py` at commit 0c2d0ea, without
`reconstruct_lossless_device` and `reconstruct_lossless_wavefront` (jnp and
`lax` code; the port's `ops/predictors.py` computes both in torch).

Lossless (SOF3) predictor reconstruction, bit-exact incl. reference quirks.

Parity with `src/decoder/lossless.rs:108-226`. All arithmetic is
modulo-2^16 on the stored (point-transform-shifted) values, exactly as the
reference computes it.

Reconstruction is an inherently sequential 2-D recurrence, but most of it
vectorizes exactly:

- Predictor 1 (Ra) with point transform 0 is a per-row prefix sum mod 2^16
  seeded by a prefix-summed first column.
- For point transform t > 0, the row recurrence is
  m[x] = (m[x-1] * 2^t + d[x]) mod 2^16, and because the multiplier is a power
  of two, contributions vanish after ceil(16/t) steps — the recurrence
  collapses to a short windowed convolution (fully parallel).
- Predictors 2 (Rb) and 3 (Rc) are row-at-a-time vector ops.
- Predictor 4 (Ra+Rb-Rc) with t=0 telescopes to a 2-D cumulative sum.
- Predictors 5-7 carry a nonlinear >>1 with no closed form; on device they run
  through the general anti-diagonal wavefront scan
  (`reconstruct_lossless_wavefront`), which evaluates every predictor and any
  point transform bit-identically. `device_supported` routes: closed forms for
  predictors 0-4 at pt=0, the wavefront for everything else.

Reference quirk reproduced deliberately: the reference's phase-2 restart check
reads the restart counter *left over from phase 1* without updating it
(`src/decoder/lossless.rs:168-171`), so the "restart" predictor
reset is a constant for the whole image — either never (the common case) or for
every pixel. We take the leftover counter as input and reproduce exactly that.
"""

from __future__ import annotations

import numpy as np

from ..parser import Predictor


def _default_prediction(precision: int, point_transform: int) -> int:
    """H.1.2.1 initial prediction (`src/decoder/lossless.rs:200-205`)."""
    if precision > 1 + point_transform:
        return 1 << (precision - point_transform - 1)
    return 0


def reconstruct_lossless(diffs: np.ndarray, predictor: Predictor, point_transform: int,
                         precision: int, restart_all: bool) -> np.ndarray:
    """Apply a lossless predictor to a difference plane.

    Args:
      diffs: int32 [H, W] Huffman-decoded differences for one component.
      predictor: Table H.1 selection.
      point_transform: Pt parameter; stored samples are shifted left by it.
      precision: frame sample precision P.
      restart_all: the reference's stale phase-2 restart flag (see module doc).

    Returns uint16 [H, W] reconstructed samples.
    """
    h, w = diffs.shape
    pt = point_transform

    from ..entropy.native import get_native
    native = get_native()
    if native is not None:
        return native.reconstruct_lossless(diffs, int(predictor), pt, precision,
                                           restart_all)

    if predictor == Predictor.RA:
        return _reconstruct_ra(diffs, pt, precision)

    if restart_all:
        # Stale-flag quirk: every pixel >= (0,0) uses the default prediction.
        default = _default_prediction(precision, pt)
        return (((default + diffs) & 0xFFFF) << pt).astype(np.uint16) & 0xFFFF

    if pt == 0 and predictor in (Predictor.RB, Predictor.RC, Predictor.RA_RB_RC_1,
                                 Predictor.NO_PREDICTION):
        return _reconstruct_vectorized_pt0(diffs, predictor, precision)

    return _reconstruct_scalar(diffs, predictor, pt, precision)


def _row_chain(seed: np.ndarray, d: np.ndarray, pt: int) -> np.ndarray:
    """Solve m[x] = (m[x-1]*2^pt + d[x]) mod 2^16 along the last axis, where
    m[-1] = seed (stored, already-shifted value). Returns stored (shifted)
    values ((...)&0xFFFF) << pt as int64.

    For pt == 0 this is a prefix sum; for pt > 0 contributions older than
    ceil(16/pt) steps are annihilated mod 2^16, giving a windowed closed form.
    """
    if pt == 0:
        acc = np.cumsum(d.astype(np.int64), axis=-1) + seed[..., None]
        return acc & 0xFFFF

    # r[x] = ((r[x-1] + d[x]) & 0xFFFF) << pt  with r[-1] = seed.
    # Let u[x] = r[x] >> pt (in [0, 2^16)): u[x] = (u[x-1]*2^pt + d[x]) mod 2^16
    # ... with u[-1]*2^pt = seed mod 2^16*2^pt — handle via the seed term.
    n = d.shape[-1]
    window = -(-16 // pt)  # ceil
    acc = np.zeros(d.shape, dtype=np.int64)
    shifted = d.astype(np.int64)
    for j in range(min(window, n)):
        if j == 0:
            contrib = shifted
        else:
            contrib = np.zeros_like(shifted)
            contrib[..., j:] = shifted[..., :-j] << (pt * j)
        acc += contrib
    # Seed contribution: seed (already shifted by pt) feeds position x with
    # multiplier 2^(pt*x); dead beyond the window.
    for x in range(min(window, n)):
        acc[..., x] += (seed.astype(np.int64) << (pt * x))
    return (acc & 0xFFFF) << pt


def _reconstruct_ra(diffs: np.ndarray, pt: int, precision: int) -> np.ndarray:
    """Predictor-1 fast path (`src/decoder/lossless.rs:108-138`):
    first pixel from default, first column chained vertically, rows chained
    horizontally. Restart resets are NOT applied (the reference fast path has
    none)."""
    h, w = diffs.shape
    # NB: the fast path computes `1 << (P - Pt - 1)` unconditionally
    # (`src/decoder/lossless.rs:112`), without the
    # small-precision guard the general `predict()` applies.
    default = 1 << (precision - pt - 1)
    d = diffs.astype(np.int64)

    # First column: r[y,0] = ((r[y-1,0] + d[y,0]) & 0xFFFF) << pt, seeded by
    # the default prediction for (0,0).
    col0_stored = _row_chain(np.asarray(default, dtype=np.int64),
                             d[:, 0], pt)  # [H] stored values

    # Rows: seeded by the stored first-column value.
    if w > 1:
        rows_stored = _row_chain(col0_stored, d[:, 1:], pt)  # [H, W-1]
        out = np.concatenate([col0_stored[:, None], rows_stored], axis=1)
    else:
        out = col0_stored[:, None]
    return (out & 0xFFFF).astype(np.uint16)


def _reconstruct_vectorized_pt0(diffs: np.ndarray, predictor: Predictor,
                                precision: int) -> np.ndarray:
    """Closed forms for pt == 0 and predictors whose recurrence is linear mod 2^16.

    Boundary semantics from `predict()` (`src/decoder/lossless.rs:
    189-226`): (0,0) uses the default, the rest of row 0 uses Ra, column 0 uses
    Rb, interior uses the selected predictor.
    """
    h, w = diffs.shape
    d = diffs.astype(np.int64)
    default = _default_prediction(precision, 0)

    # Row 0: horizontal chain from the default.
    row0 = (np.cumsum(d[0], axis=-1) + default) & 0xFFFF  # [W]

    if h == 1:
        return row0[None, :].astype(np.uint16)

    if predictor in (Predictor.RB, Predictor.NO_PREDICTION):
        # Column-wise chains: r[y,x] = r[y-1,x] + d[y,x] (interior pred = Rb;
        # NoPrediction's interior pred is 0, handled below).
        if predictor == Predictor.RB:
            acc = np.cumsum(d[1:], axis=0) + row0[None, :]
            return (np.concatenate([row0[None, :], acc & 0xFFFF]) & 0xFFFF).astype(np.uint16)
        # NO_PREDICTION: interior & row-0-interior pred rules still apply for
        # row 0 (Ra) and col 0 (Rb); interior pred = 0 -> r = d & 0xFFFF.
        col0 = (np.cumsum(d[1:, 0]) + row0[0]) & 0xFFFF
        out = d[1:, :] & 0xFFFF
        out[:, 0] = col0
        return np.concatenate([row0[None, :], out]).astype(np.uint16)

    if predictor == Predictor.RC:
        # r[y,x] = r[y-1,x-1] + d[y,x] interior; col 0 = Rb chain. Row-at-a-time.
        out = np.empty((h, w), dtype=np.int64)
        out[0] = row0
        for y in range(1, h):
            prev = out[y - 1]
            row = np.empty(w, dtype=np.int64)
            row[0] = (prev[0] + d[y, 0]) & 0xFFFF
            row[1:] = (prev[:-1] + d[y, 1:]) & 0xFFFF
            out[y] = row
        return out.astype(np.uint16)

    if predictor == Predictor.RA_RB_RC_1:
        # Ra + Rb - Rc telescopes: with g[y,x] = r[y,x] - r[y-1,x] (mod 2^16),
        # g[y,x] = g[y,x-1] + d[y,x] and g[y,0] = d[y,0] (col-0 Rb rule), so
        # r = row0 + column-cumsum of row-cumsums. This is the TPU-native form:
        # two cumulative sums, no sequential scan.
        row_cum = np.cumsum(d[1:], axis=1)          # [H-1, W]
        col_cum = np.cumsum(row_cum, axis=0)         # [H-1, W]
        out = (row0[None, :] + col_cum) & 0xFFFF
        return np.concatenate([row0[None, :], out]).astype(np.uint16)

    raise AssertionError(predictor)


def device_supported(predictor: Predictor, point_transform: int) -> bool:
    """Configurations covered by the *closed-form* device path; everything
    else still runs on device via the wavefront scan below."""
    return point_transform == 0 and predictor in (
        Predictor.NO_PREDICTION, Predictor.RA, Predictor.RB, Predictor.RC,
        Predictor.RA_RB_RC_1)


def _reconstruct_scalar(diffs: np.ndarray, predictor: Predictor, pt: int,
                        precision: int) -> np.ndarray:
    """Exact scalar loop for the remaining cases
    (`src/decoder/lossless.rs:139-177`)."""
    h, w = diffs.shape
    out = np.zeros((h, w), dtype=np.int64)
    default = _default_prediction(precision, pt)

    for y in range(h):
        for x in range(w):
            if x == 0 and y == 0:
                prediction = default
            elif y == 0:
                prediction = int(out[0, x - 1])
            elif x == 0:
                prediction = int(out[y - 1, 0])
            else:
                ra = int(out[y, x - 1])
                rb = int(out[y - 1, x])
                rc = int(out[y - 1, x - 1])
                if predictor == Predictor.NO_PREDICTION:
                    prediction = 0
                elif predictor == Predictor.RA:
                    prediction = ra
                elif predictor == Predictor.RB:
                    prediction = rb
                elif predictor == Predictor.RC:
                    prediction = rc
                elif predictor == Predictor.RA_RB_RC_1:
                    prediction = ra + rb - rc
                elif predictor == Predictor.RA_RB_RC_2:
                    prediction = ra + ((rb - rc) >> 1)
                elif predictor == Predictor.RA_RB_RC_3:
                    prediction = rb + ((ra - rc) >> 1)
                elif predictor == Predictor.RA_RB:
                    prediction = (ra + rb) // 2
                else:
                    raise AssertionError(predictor)
            # Stored samples are u16: the point-transform shift wraps
            # (`result << pt` on u16 keeps the low 16 bits).
            out[y, x] = (((prediction + int(diffs[y, x])) & 0xFFFF) << pt) & 0xFFFF

    return out.astype(np.uint16)

"""Lossless (SOF3) predictor reconstruction on the device, bit-exact with
the reference's host oracle, reference quirks included.

Port of `jpeg_decoder_tpu/ops/predictors.py`:
- `reconstruct_lossless_device`: the closed forms (Ra as prefix sums and
  dispatched before the restart check, the `restart_all` quirk, no
  prediction, Rb and Ra+Rb-Rc through cumsums), for the configurations
  `device_supported` names (imported from the host copy, with
  `_default_prediction`).
  The Rc row chain is a `lax.scan` over rows in the reference; here it
  runs through kernel L1, whose wavefront computes the same recurrence.
- `reconstruct_lossless_wavefront`: every predictor at any point
  transform, through kernel L1.

Kernel L1 `lossless_recur` (`csrc/lossless_recur.cu`) is the port of the
reference's anti-diagonal `lax.scan` (`reconstruct_lossless_wavefront`,
and the Rc chain), which XLA runs as one device loop; it replaces no
Pallas kernel. Eager torch would spend ~15 launches on each of the H+W-1
diagonals, so the recurrence is one kernel; `lossless_recur_plain` is that
diagonal loop of vector ops, the plain version beside it.

Planes are int32 throughout, each value the stored (shifted) 16-bit
sample; callers narrow to uint8/uint16 once, at the end.
"""

from __future__ import annotations

import torch

from ..host.ops.predictors import _default_prediction, device_supported
from ..host.parser import Predictor

from .. import _build

MASK = 0xFFFF


def _check_recur(diffs, predictor: int, pt: int) -> None:
    if diffs.dtype != torch.int32 or diffs.dim() != 3 \
            or not diffs.is_contiguous():
        raise ValueError("diffs must be contiguous int32 [C, H, W]")
    c, h, w = diffs.shape
    if min(c, h, w) < 1 or diffs.numel() >= 2 ** 31:
        raise ValueError(f"diffs shape {tuple(diffs.shape)} out of range")
    if not 0 <= int(predictor) <= 7 or not 0 <= pt <= 15:
        raise ValueError(f"predictor {predictor} / point transform {pt} "
                         "out of range")


def lossless_recur(diffs, predictor: int, pt: int, default: int
                   ) -> torch.Tensor:
    """Kernel L1: int32 [C, H, W] differences (each in [0, 2^16)) -> int32
    [C, H, W] stored samples of `predictor` (0-7) with point transform
    `pt`, the first sample predicted by `default`. Every component is one
    recurrence of its own."""
    _check_recur(diffs, predictor, pt)
    if diffs.device.type == "cpu":
        return lossless_recur_plain(diffs, predictor, pt, default)
    if diffs.device.type != "cuda":
        raise ValueError(f"no L1 implementation for device {diffs.device}")
    c, h, w = diffs.shape
    out = torch.empty_like(diffs)
    lib = _build.load()
    with torch.cuda.device(diffs.device):
        err = lib.jdt_lossless_recur(
            diffs.data_ptr(), c, h, w, int(predictor), pt, int(default),
            out.data_ptr(),
            torch.cuda.current_stream(diffs.device).cuda_stream)
        _build.count_launch("lossless_recur")
    _build.check(lib, err, "lossless_recur")
    return out


def lossless_recur_plain(diffs, predictor: int, pt: int, default: int
                         ) -> torch.Tensor:
    """Plain PyTorch version of L1: the reference's wavefront, one vector
    step per anti-diagonal k over every row y (column x = k - y), carrying
    diagonals k-1 (Ra, Rb) and k-2 (Rc)."""
    c, h, w = diffs.shape
    dev = diffs.device
    predictor = Predictor(predictor)
    n_diag = h + w - 1
    ys = torch.arange(h, device=dev)
    xs = torch.arange(n_diag, device=dev)[:, None] - ys[None, :]   # [D, H]
    valid = (xs >= 0) & (xs < w)
    ddiag = torch.where(valid, diffs[:, ys[None, :], xs.clamp(0, w - 1)],
                        0)                                      # [C, D, H]
    top = ys == 0
    zero = diffs.new_zeros((c, 1))
    prev = prev2 = diffs.new_zeros((c, h))
    diag_vals = diffs.new_empty((c, n_diag, h))
    for k in range(n_diag):
        ra = prev                                   # r[y, x-1]
        rb = torch.cat([zero, prev[:, :-1]], 1)     # r[y-1, x]
        rc = torch.cat([zero, prev2[:, :-1]], 1)    # r[y-1, x-1]
        if predictor == Predictor.NO_PREDICTION:
            interior = torch.zeros_like(ra)
        elif predictor == Predictor.RA:
            interior = ra
        elif predictor == Predictor.RB:
            interior = rb
        elif predictor == Predictor.RC:
            interior = rc
        elif predictor == Predictor.RA_RB_RC_1:
            interior = ra + rb - rc
        elif predictor == Predictor.RA_RB_RC_2:
            interior = ra + ((rb - rc) >> 1)
        elif predictor == Predictor.RA_RB_RC_3:
            interior = rb + ((ra - rc) >> 1)
        else:                                       # RA_RB
            interior = (ra + rb) // 2
        left = ys == k                              # x == 0
        pred = torch.where(top, ra, torch.where(left, rb, interior))
        pred = torch.where(top & left, default, pred)
        cur = ((pred + ddiag[:, k]) & MASK) * (1 << pt) & MASK
        cur = torch.where(valid[k], cur, 0)
        diag_vals[:, k] = cur
        prev2, prev = prev, cur
    cols = torch.arange(w, device=dev)
    return diag_vals[:, cols[None, :] + ys[:, None], ys[:, None]]


def reconstruct_lossless_device(d, predictor, pt: int, precision: int,
                                restart_all: bool) -> torch.Tensor:
    """Closed forms: int32 [..., H, W] differences in [0, 2^16) -> int32
    [..., H, W] stored samples, for Ra at pt 0, `restart_all`, and what
    `device_supported` names; every op runs once over the leading planes.
    Sums run in int64 (torch's default for an integer cumsum) and are
    masked to 16 bits, as the reference's wrapping int32 sums are."""
    h, w = d.shape[-2:]
    if predictor == Predictor.RA:
        # Dispatched before the restart check, with the unguarded default.
        if pt != 0:
            raise ValueError("Ra with a point transform has no device form "
                             "(staging sends it to the host)")
        col0 = (torch.cumsum(d[..., 0], -1) + (1 << (precision - 1))) & MASK
        if w == 1:
            return col0[..., None].to(torch.int32)
        rows = (torch.cumsum(d[..., 1:], -1) + col0[..., None]) & MASK
        return torch.cat([col0[..., None], rows], -1).to(torch.int32)

    if restart_all:
        default = _default_prediction(precision, pt)
        return ((default + d) & MASK) * (1 << pt) & MASK

    if not device_supported(predictor, pt):
        raise ValueError(f"predictor {predictor} at pt {pt} has no closed "
                         "form; use reconstruct_lossless_wavefront")
    default = _default_prediction(precision, 0)
    if predictor == Predictor.RC:
        return lossless_recur(d.reshape(-1, h, w).contiguous(), Predictor.RC,
                              0, default).reshape(d.shape)
    row0 = (torch.cumsum(d[..., 0, :], -1) + default) & MASK
    if h == 1:
        return row0[..., None, :].to(torch.int32)
    if predictor == Predictor.RB:
        body = (torch.cumsum(d[..., 1:, :], -2) + row0[..., None, :]) & MASK
    elif predictor == Predictor.NO_PREDICTION:
        col0 = (torch.cumsum(d[..., 1:, 0], -1) + row0[..., :1]) & MASK
        body = torch.cat([col0[..., None].to(torch.int32),
                          d[..., 1:, 1:] & MASK], -1)
    else:                                           # RA_RB_RC_1
        body = (torch.cumsum(torch.cumsum(d[..., 1:, :], -1), -2)
                + row0[..., None, :]) & MASK
    return torch.cat([row0[..., None, :].to(torch.int32),
                      body.to(torch.int32)], -2)


def reconstruct_lossless_wavefront(d, predictor, pt: int, precision: int
                                   ) -> torch.Tensor:
    """Any predictor, any point transform: int32 [H, W] differences ->
    int32 [H, W] stored samples, through L1."""
    return lossless_recur(d[None].contiguous(), predictor, pt,
                          _default_prediction(precision, pt))[0]


def runs_l1(predictor, pt: int, restart_all: bool) -> bool:
    """Whether the reference's `_compiled_lossless_pipeline` rule sends this
    configuration to the recurrence: the Rc row chain at pt 0, and every
    predictor but Ra that has no closed form (predictors 5-7 at any pt,
    0-4 at pt > 0). Ra and `restart_all` have closed forms."""
    if predictor == Predictor.RA or restart_all:
        return False
    return predictor == Predictor.RC or not device_supported(predictor, pt)


def reconstruct_planes(d, predictor, pt: int, precision: int,
                       restart_all: bool) -> torch.Tensor:
    """Every plane, int32 [P, H, W] differences -> int32 [P, H, W] stored
    samples (P = C components of one image, or N * C for a group of N), by
    the rule of the reference's `_compiled_lossless_pipeline`: the closed
    forms, vectorised over the planes, or L1 once for all planes (one
    launch per image or per group)."""
    if runs_l1(predictor, pt, restart_all):
        return lossless_recur(d.contiguous(), predictor, pt,
                              _default_prediction(precision, pt))
    return reconstruct_lossless_device(d, predictor, pt, precision,
                                       restart_all)

"""The plain reference of the exact tier: a baseline YCbCr 4:2:0 image from
its quantised coefficients, in plain PyTorch, on any device.

The arithmetic is the host oracle's (`jpeg_decoder_tpu_torch/host/ops/
idct.py::_idct8x8`, `upsample.py` H2V2 and H1V1, `color.py::ycbcr_to_rgb`:
the jpeg-decoder crate's stb-derived integer IDCT, its fancy upsampling
and its fixed-point BT.601), copied and written for torch tensors; nothing
of the port is imported and nothing the port made is read. Every value is
an int32 computed exactly as there, so the result is the same on the CPU
and on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def _f2f(x: float, bits: int) -> int:
    """trunc(f32(x) * 2^bits + 0.5) in f32, as the crate computes its
    fixed-point constants."""
    return int(np.float32(np.float32(x) * np.float32(1 << bits))
               + np.float32(0.5))


C0_541, CM1_847, C0_765 = _f2f(0.5411961, 12), _f2f(-1.847759065, 12), \
    _f2f(0.765366865, 12)
C1_175, C0_298, C2_053 = _f2f(1.175875602, 12), _f2f(0.298631336, 12), \
    _f2f(2.053119869, 12)
C3_072, C1_501, CM0_899 = _f2f(3.072711026, 12), _f2f(1.501321110, 12), \
    _f2f(-0.899976223, 12)
CM2_562, CM1_961, CM0_390 = _f2f(-2.562915447, 12), \
    _f2f(-1.961570560, 12), _f2f(-0.390180644, 12)
X_SCALE_ROW = 65536 + (128 << 17)
R_CR, G_CB, G_CR, B_CB = _f2f(1.40200, 20), _f2f(0.34414, 20), \
    _f2f(0.71414, 20), _f2f(1.77200, 20)


def _even(s0, s2, s4, s6, bias: int):
    p1 = (s2 + s6) * C0_541
    t2 = p1 + s6 * CM1_847
    t3 = p1 + s2 * C0_765
    t0 = (s0 + s4) * 4096
    t1 = (s0 - s4) * 4096
    return t0 + t3 + bias, t1 + t2 + bias, t1 - t2 + bias, t0 - t3 + bias


def _odd(s1, s3, s5, s7):
    p3, p4, p1, p2 = s7 + s3, s5 + s1, s7 + s1, s5 + s3
    p5 = (p3 + p4) * C1_175
    p1 = p5 + p1 * CM0_899
    p2 = p5 + p2 * CM2_562
    p3 = p3 * CM1_961
    p4 = p4 * CM0_390
    return (s7 * C0_298 + p1 + p3, s5 * C2_053 + p2 + p4,
            s3 * C3_072 + p2 + p3, s1 * C1_501 + p1 + p4)


def _butterfly(s, axis: int, bias: int, shift: int):
    """One pass of the 8-point integer IDCT along `axis` of int32 [..., 8,
    8] (-2: columns, -1: rows)."""
    sel = [s.select(axis, i) for i in range(8)]
    x0, x1, x2, x3 = _even(sel[0], sel[2], sel[4], sel[6], bias)
    t0, t1, t2, t3 = _odd(sel[1], sel[3], sel[5], sel[7])
    return torch.stack([x0 + t3, x1 + t2, x2 + t1, x3 + t0, x3 - t0,
                        x2 - t1, x1 - t2, x0 - t3], axis) >> shift


def idct_blocks(coefs: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """int16 [N, 64] natural-order coefficients and a [64] table -> uint8
    [N, 8, 8]: dequantise, the column pass (with the crate's zero-AC-column
    shortcut, dc << 2), the row pass, +128, clamp."""
    c = coefs.to(torch.int32).reshape(-1, 8, 8)
    s = c * qt.to(torch.int32).reshape(8, 8)
    temp = _butterfly(s, -2, 512, 10)
    ac_zero = (c[:, 1:, :] == 0).all(1, keepdim=True)
    temp = torch.where(ac_zero, s[:, :1, :] * 4, temp)
    out = _butterfly(temp, -1, X_SCALE_ROW, 17)
    return out.clamp(0, 255).to(torch.uint8)


def plane(coefs: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """int16 [bh, bw, 64] -> the component's uint8 [bh * 8, bw * 8]."""
    bh, bw, _ = coefs.shape
    px = idct_blocks(coefs.reshape(-1, 64), qt)
    return px.reshape(bh, bw, 8, 8).permute(0, 2, 1, 3).reshape(bh * 8,
                                                                bw * 8)


def upsample_h2v2(p: torch.Tensor, in_w: int, in_h: int, out_h: int,
                  out_w: int) -> torch.Tensor:
    """The crate's H2V2 filter (`upsample.py::h2v2_combine`): per output
    row its near and far input rows, t = 3 near + far, then per column
    (3 t + t[i -/+ 1] + 8) >> 4, the edge columns (t + 2) >> 2."""
    p2 = p[:in_h, :in_w].to(torch.int32)
    near = p2.repeat_interleave(2, 0)[:out_h]
    down = torch.cat([p2[:1], p2[:-1]], 0)
    up = torch.cat([p2[1:], p2[-1:]], 0)
    far = torch.stack([down, up], 1).reshape(2 * in_h, in_w)[:out_h]
    t = 3 * near + far
    if in_w == 1:
        col = (t[:, 0] + 2) >> 2
        return torch.stack([col, col], -1)[:, :out_w].to(torch.uint8)
    t_prev = torch.cat([t[:, :1], t[:, :-1]], 1)
    t_next = torch.cat([t[:, 1:], t[:, -1:]], 1)
    out = torch.stack([(3 * t + t_prev + 8) >> 4, (3 * t + t_next + 8) >> 4],
                      -1).reshape(out_h, 2 * in_w)
    out[:, 0] = (t[:, 0] + 2) >> 2
    out[:, -1] = (t[:, -1] + 2) >> 2
    return out[:, :out_w].to(torch.uint8)


def ycbcr_to_rgb(y, cb, cr) -> torch.Tensor:
    """The crate's fixed-point BT.601: uint8 [H, W, 3]."""
    y = y.to(torch.int32) * (1 << 20) + (1 << 19)
    cb = cb.to(torch.int32) - 128
    cr = cr.to(torch.int32) - 128
    rgb = [y + R_CR * cr, y - G_CB * cb - G_CR * cr, y + B_CB * cb]
    return torch.stack([(v >> 20).clamp(0, 255) for v in rgb],
                       -1).to(torch.uint8)


def reconstruct(item: dict, height: int, width: int,
                device) -> torch.Tensor:
    """One photo of the generator's pool (`gen/photo.py`: its coefficients
    and tables) -> uint8 [H, W, 3] on `device`: the interleaved image the
    exact tier must return, bit for bit."""
    planes = [plane(torch.from_numpy(c).to(device),
                    torch.from_numpy(q.astype(np.int32)).to(device))
              for c, q in zip(item["coefs"], item["qts"])]
    cw, ch = -(-width // 2), -(-height // 2)
    y = planes[0][:height, :width]
    cb, cr = (upsample_h2v2(p, cw, ch, height, width) for p in planes[1:])
    return ycbcr_to_rgb(y, cb, cr)


def expected(item: dict, config: dict, device) -> torch.Tensor:
    """The configuration's output for one pool item (`reconstruct`)."""
    return reconstruct(item, config["height"], config["width"], device)

"""Kernel K2: dequantize + IDCT of coefficient blocks.

Counterpart of `jpeg_decoder_tpu/ops/pallas_kernels.py::
dequantize_and_idct_blocks_pallas` (the TPU kernel `_kernel_fn`):
    pixels = u8(clip(floor((coef * q) @ basis + 128.5), 0, 255))
in fp32, on int16 [N, 64] natural-order blocks. Scales 8/4/2/1 share one
kernel through the zero-padded [64, 64] basis (`params.idct_basis`); only
the first scale * scale pixel columns are computed.

`dequant_idct` dispatches on the device of its inputs: CPU tensors run
`dequant_idct_plain`, CUDA tensors launch the CUDA kernel
(`csrc/dequant_idct.cu`), anything else raises. The kernel and the plain
version sum the 64 products in different orders, so they may differ by 1
where a value lands next to a .5 boundary.
"""

from __future__ import annotations

import torch

from .. import _build


def _check_inputs(coef, q, basis, scale: int) -> None:
    dev = coef.device
    for name, t, dtype in (("coef", coef, torch.int16),
                           ("q", q, torch.float32),
                           ("basis", basis, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, coef on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if coef.dim() != 2 or coef.shape[1] != 64:
        raise ValueError(f"coef must be [N, 64], got {tuple(coef.shape)}")
    if q.shape != (64,) or basis.shape != (64, 64):
        raise ValueError("q must be [64] and basis [64, 64]")
    if scale not in (1, 2, 4, 8):
        raise ValueError(f"unsupported IDCT scale {scale}")
    if coef.shape[0] >= 2 ** 31 // 64:
        raise ValueError("too many blocks for one launch")


def dequant_idct(coef, q, basis, scale: int = 8) -> torch.Tensor:
    """int16 [N, 64] coefficients, float32 [64] dequant factors, float32
    [64, 64] basis -> uint8 [N, scale * scale] pixels."""
    _check_inputs(coef, q, basis, scale)
    if coef.device.type == "cpu":
        return dequant_idct_plain(coef, q, basis, scale)
    if coef.device.type != "cuda":
        raise ValueError(f"no K2 implementation for device {coef.device}")
    n_out = scale * scale
    out = torch.empty((coef.shape[0], n_out), dtype=torch.uint8,
                      device=coef.device)
    lib = _build.load()
    with torch.cuda.device(coef.device):
        err = lib.jdt_dequant_idct(
            coef.data_ptr(), coef.shape[0], q.data_ptr(), basis.data_ptr(),
            n_out, out.data_ptr(),
            torch.cuda.current_stream(coef.device).cuda_stream)
        _build.LAUNCHES["dequant_idct"] += 1
    _build.check(lib, err, "dequant_idct")
    return out


def dequant_idct_plain(coef, q, basis, scale: int = 8) -> torch.Tensor:
    """Plain PyTorch version of K2: one fp32 matmul. On the card it must run
    in full fp32 (no TF32), as the reference runs at Precision.HIGHEST."""
    if coef.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                         or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("the fp32 reference needs TF32 matmuls off")
    n_out = scale * scale
    y = (coef.to(torch.float32) * q) @ basis[:, :n_out]
    return torch.floor(y + 128.5).clamp_(0, 255).to(torch.uint8)

"""The prefix rebuild: the prefix interchange's staged wire -> coefficient
stores.

Port of the rebuild in `jpeg_decoder_tpu/models/stream.py::
_compiled_prefix_pipeline` (and `_compiled_prefix_pipeline_batched`, one
image after another): per block the DC (int16) and zigzag AC slots 1..15
(int8, sign-extended), zero past slot 15, permuted to natural order; then
the residuals scatter-added in int16 (wrapping mod 2^16) with
`.at[idx].add(mode="drop")`'s reading of an index: duplicates add, an index
in [-total, 0) counts from the end, any other index outside [0, total) is
dropped.

`prefix_stores` dispatches on the device of `dc`: CPU tensors run
`prefix_stores_plain`, CUDA tensors launch kernel P1
(`csrc/prefix_rebuild.cu`: a base pass, then a residual pass, two
launches in stream order), anything else raises.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import _build
from ..host.staging import _ZIGZAG_OF_NATURAL, PREFIX_K


def _split(geometry, dense: torch.Tensor, n: int, nb: int) -> list:
    """One int16 [n, blocks, 64] view per component of the flat stores of
    n images (each image's slab of a component contiguous)."""
    sizes = [c.blocks_high * c.blocks_wide * 64 for c in geometry.components]
    return [s.view(n, -1, 64)
            for s in dense.view(n, nb * 64).split(sizes, dim=1)]


@lru_cache(maxsize=None)
def _natural_perm(device: torch.device) -> torch.Tensor:
    """The zigzag index of each natural position, int64 [64] on `device`:
    copied there once, not in every call."""
    return torch.as_tensor(_ZIGZAG_OF_NATURAL, dtype=torch.int64).to(device)


def prefix_stores(geometry, dc, ac, resid_idx, resid_vals) -> list:
    """The reference's `_compiled_prefix_pipeline` up to the stores, for one
    image or a group of N of one geometry: int16 dc [N, n] (or [n]) and int8
    ac [N, n, 15] (zigzag slots 1..15) -> zigzag [N, n, 64] int16,
    permuted to natural order, plus the residuals scatter-added (wrapping in
    int16). `resid_idx` indexes the group's stores flattened image after
    image (image i's indices offset by i times an image's coefficients),
    read as `mode="drop"` reads it (module docstring). Returns one int16
    [N, blocks, 64] store per component (views of one allocation: each
    image's slab of a component is contiguous). CPU tensors run
    `prefix_stores_plain`, CUDA tensors kernel P1 (at most two launches),
    anything else raises."""
    if dc.device.type == "cpu":
        return prefix_stores_plain(geometry, dc, ac, resid_idx, resid_vals)
    if dc.device.type != "cuda":
        raise ValueError(f"no P1 implementation for device {dc.device}")
    return _prefix_p1(geometry, dc, ac, resid_idx, resid_vals)


def prefix_stores_plain(geometry, dc, ac, resid_idx, resid_vals) -> list:
    """Plain PyTorch version of P1, arguments and result as
    `prefix_stores`'. The dropped residuals go to a sink element past the
    end. Runs on any device; the CPU path and `chip_smoke.py`'s on-card
    comparison use it."""
    dc = dc.reshape(-1, dc.shape[-1])
    n, nb = dc.shape
    padded = torch.cat([dc[..., None], ac.reshape(n, nb, -1).to(torch.int16),
                        dc.new_zeros((n, nb, 64 - PREFIX_K))], dim=-1)
    total = n * nb * 64
    dense = torch.cat([padded[..., _natural_perm(dc.device)].reshape(-1),
                       dc.new_zeros(1)])
    idx = resid_idx.reshape(-1).to(torch.int64)
    idx = torch.where(idx < 0, idx + total, idx)
    idx = torch.where((idx >= 0) & (idx < total), idx, total)
    dense.index_add_(0, idx, resid_vals.reshape(-1))
    return _split(geometry, dense[:total], n, nb)


def _check_p1(dc, ac, resid_idx, resid_vals) -> None:
    n, nb = dc.shape
    for name, t, dtype in (("dc", dc, torch.int16), ("ac", ac, torch.int8),
                           ("resid_idx", resid_idx, torch.int32),
                           ("resid_vals", resid_vals, torch.int16)):
        if t.device != dc.device:
            raise ValueError(f"{name} is on {t.device}, dc on {dc.device}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}, got "
                             f"{t.dtype}")
    if ac.numel() != n * nb * (PREFIX_K - 1):
        raise ValueError(f"ac {tuple(ac.shape)} must hold {PREFIX_K - 1} "
                         f"slots for each of {n} x {nb} blocks")
    if resid_idx.numel() != resid_vals.numel():
        raise ValueError(f"resid_idx {tuple(resid_idx.shape)} and resid_vals "
                         f"{tuple(resid_vals.shape)} differ in size")
    if n * nb * 64 >= 2 ** 31:
        raise ValueError(f"{n} x {nb} blocks: the stores' indices pass int32")


def _p1_launch(lib, dc, ac, resid_idx, resid_vals, out, stream) -> int:
    """The launches of a P1 rebuild of dc's blocks into `out` (the base
    pass, then the residual pass where there are residuals), their error
    code."""
    return lib.jdt_prefix_rebuild(dc.data_ptr(), ac.data_ptr(), dc.numel(),
                                  resid_idx.data_ptr(), resid_vals.data_ptr(),
                                  resid_idx.numel(), out.data_ptr(), stream)


def _prefix_p1(geometry, dc, ac, resid_idx, resid_vals) -> list:
    dc = dc.reshape(-1, dc.shape[-1])
    _check_p1(dc, ac, resid_idx, resid_vals)
    n, nb = dc.shape
    out = torch.empty(n * nb * 64, dtype=torch.int16, device=dc.device)
    if out.numel():
        lib = _build.load()
        with torch.cuda.device(dc.device):
            stream = torch.cuda.current_stream(dc.device).cuda_stream
            err = _p1_launch(lib, dc, ac, resid_idx, resid_vals, out, stream)
            _build.count_launch("prefix_rebuild",
                                1 + bool(resid_idx.numel()))
        _build.check(lib, err, "prefix_rebuild")
    return _split(geometry, out, n, nb)

"""Assembly: stream-order `nat` -> per-component coefficient stores.

Port of `jpeg_decoder_tpu/entropy/device_scan.py::build_assembler_nat`:
segmented DC prefix sums (the DC column of `nat` holds wrap16
differences; restart segments reset the predictor) and the stream ->
raster rearrangement into one int16 [block_h * block_w, 64] store per scan
component, zero rows where the block grid pads past the decoded MCUs.

Both of the reference's strategies are here, with identical outputs:
- `assemble_structured` (the reference's `plan.structured` branch): the
  maps are reshape/permute/pad, no index arrays. Used whenever the plan
  has the verified closed form, which every baseline product-path scan
  does.
- `assemble_general` (the `stream_idx`/`raster_src` branch): row gathers
  through the plan's index arrays, for geometries the closed form does
  not model.

DC semantics: the prefix sum runs in int64 and wraps to int16 at the end,
which equals the reference's int32 sum narrowed to int16 (both are the sum
mod 2^16).

The DC seam carry (`build_assembler_nat(dc_carry_axis=...)`, for one
MCU-row stripe of an image, `parallel/stripe_bits.py`): `carry`, one int64
value per scan component (or per image of a group, [N]), is added to the
non-segmented prefix sums before the wrap; the carry itself is the sum of
every earlier stripe's `dc_totals`. Restart-segmented components take no
carry (`device_scan.py:918-922`): the stripe splitter only accepts restart
segments that lie inside a stripe, so their DC resets are stripe-local.
"""

from __future__ import annotations

import numpy as np
import torch


def _segmented_dc(diffs: torch.Tensor, seg_blocks: int,
                  carry=None) -> torch.Tensor:
    """Prefix sums of int16 DC diffs along the last axis, restarting every
    `seg_blocks` blocks (0: one segment) and at every leading index (an
    image of a group: no sum runs from one image into the next), plus
    `carry` (int64 per leading index) where seg_blocks is 0. Returns
    int64."""
    cum = torch.cumsum(diffs, -1, dtype=torch.int64)
    n = cum.shape[-1]
    if 0 < seg_blocks < n:
        prev = torch.cat([cum.new_zeros((*cum.shape[:-1], 1)), cum], -1)
        nseg = -(-n // seg_blocks)
        seg_base = prev[..., :nseg * seg_blocks:seg_blocks].repeat_interleave(
            seg_blocks, dim=-1)[..., :n]
        return cum - seg_base
    if carry is not None and seg_blocks == 0:
        return cum + carry[..., None]
    return cum


def _carry_of(carry, i: int, n: int):
    """Scan component i's carry as int64 [n] (one per image), or None."""
    if carry is None:
        return None
    return torch.as_tensor(carry[i], dtype=torch.int64).reshape(-1).expand(n)


def dc_totals(nat: torch.Tensor, plan) -> torch.Tensor:
    """Sum of the DC diffs of each scan component in `nat` (int16 [n_blocks,
    64] in stream order, or [N, n_blocks, 64]) of a plan with the
    structured form (every stripe's: the splitter declines the others):
    int64 [ncomp] (or [N, ncomp]). For a stripe, the carry of the next:
    the reference's `_dc_carry` all-gathers `cum[-1]`, this sum."""
    if nat.dim() == 2:
        return dc_totals(nat[None], plan)[0]
    (n_mcus, _rows_d, _cols_d, plen), specs = plan.structured
    dc = nat.reshape(nat.shape[0], n_mcus, plen, 64)[..., 0]
    return torch.stack([dc[:, :, s0:s0 + bpm].sum((1, 2), dtype=torch.int64)
                        for (s0, bpm, *_rest) in specs], 1)


def assemble_structured(nat: torch.Tensor, plan, carry=None) -> list:
    """`plan.structured` branch. nat: int16 [n_blocks, 64] of one image, or
    [N, n_blocks, 64] of N images of one plan (stores [N, hc * wc, 64],
    one contiguous tensor per component, each image's as it is alone).
    `carry`: the DC seam carry per scan component (module docstring)."""
    if nat.dim() == 2:
        return [s[0] for s in assemble_structured(nat[None], plan, carry)]
    (n_mcus, rows_d, cols_d, plen), specs = plan.structured
    n = nat.shape[0]
    by_mcu = nat.reshape(n, n_mcus, plen, 64)
    stores = []
    for i, (slot0, bpm, vs, hs, hc, wc, seg_blocks) in enumerate(specs):
        rows = by_mcu[:, :, slot0:slot0 + bpm].reshape(n, -1, 64)
        dc = _segmented_dc(rows[..., 0], seg_blocks,
                           _carry_of(carry, i, n)).to(torch.int16)

        def rasterize(t):
            t = t.reshape(n, rows_d, cols_d, vs, hs, *t.shape[2:])
            return t.transpose(2, 3).reshape(n, rows_d * vs, cols_d * hs,
                                             *t.shape[5:])

        grid = nat.new_zeros((n, hc, wc, 64))
        grid[:, :rows_d * vs, :cols_d * hs] = rasterize(rows)
        grid[:, :rows_d * vs, :cols_d * hs, 0] = rasterize(dc)
        stores.append(grid.reshape(n, hc * wc, 64))
    return stores


class GeneralMaps:
    """The plan's index arrays (stream_idx, seg_first, raster_src) on one
    device, built once per plan."""

    def __init__(self, plan, device):
        def put(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(device)

        self.stream_idx = [put(a) for a in plan.stream_idx]
        self.seg_first = [put(a) for a in plan.seg_first]
        self.raster_src = [put(a) for a in plan.raster_src]
        self.restart_interval = plan.restart_interval


def assemble_general(nat: torch.Tensor, maps: GeneralMaps,
                     carry=None) -> list:
    """`stream_idx`/`raster_src` branch, nat as in `assemble_structured`:
    the same maps along the leading axis. `carry` as there, taken only
    where the plan has no restart interval (`maps.restart_interval`)."""
    if nat.dim() == 2:
        return [s[0] for s in assemble_general(nat[None], maps, carry)]
    n = nat.shape[0]
    stores = []
    for i, (s_idx, first, src) in enumerate(zip(
            maps.stream_idx, maps.seg_first, maps.raster_src)):
        rows = nat[:, s_idx]                                # stream order
        cum = torch.cumsum(rows[..., 0], -1, dtype=torch.int64)
        prev = torch.cat([cum.new_zeros((n, 1)), cum], -1)
        dc = cum - prev[:, first]
        if carry is not None and maps.restart_interval == 0:
            dc = dc + _carry_of(carry, i, n)[:, None]
        rows[..., 0] = dc.to(torch.int16)                   # wrap16
        ext = torch.cat([rows, rows.new_zeros((n, 1, 64))], 1)
        stores.append(ext[:, src])
    return stores


def assemble_nat(nat: torch.Tensor, plan, maps: GeneralMaps = None,
                 carry=None) -> list:
    """Structured when the plan has the closed form, else general (`maps`
    is then required). nat: int16 [n_blocks, 64] of one image, or
    [N, n_blocks, 64] of N images of one plan; `carry` the DC seam carry
    (module docstring)."""
    if plan.structured is not None:
        return assemble_structured(nat, plan, carry)
    if maps is None:
        raise ValueError("plan has no structured form; pass GeneralMaps")
    return assemble_general(nat, maps, carry)

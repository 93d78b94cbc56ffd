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

`assemble_nat` dispatches on the device of `nat`: CPU tensors run
`assemble_nat_plain` (the two branches above), CUDA tensors launch kernel
A1 (`csrc/assemble.cu`: both branches, every component and image in one
launch, the stores one allocation with a contiguous view per component;
its look-back's epoch from the host, or inside a captured graph's body
from its status buffer, `_build.graph_scope`), anything else raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .. import _build

A1_ROWS = 256           # blocks of a tile: kRows of csrc/assemble.cu


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
    the reference's `_dc_carry` all-gathers `cum[-1]`, this sum. CPU
    tensors run `dc_totals_plain`, CUDA tensors kernel D1
    (`csrc/dc_totals.cu`, one launch), anything else raises; a plan
    without the structured form raises."""
    if plan.structured is None:
        raise ValueError("dc_totals needs a plan with the structured form")
    if nat.device.type == "cpu":
        return dc_totals_plain(nat, plan)
    if nat.device.type != "cuda":
        raise ValueError(f"no D1 implementation for device {nat.device}")
    return _dc_totals_d1(nat, plan)


def dc_totals_plain(nat: torch.Tensor, plan) -> torch.Tensor:
    """Plain PyTorch version of D1, arguments and result as `dc_totals`'.
    Runs on any device; the CPU path and `chip_smoke.py`'s on-card
    comparison use it."""
    if nat.dim() == 2:
        return dc_totals_plain(nat[None], plan)[0]
    (n_mcus, _rows_d, _cols_d, plen), specs = plan.structured
    dc = nat.reshape(nat.shape[0], n_mcus, plen, 64)[..., 0]
    return torch.stack([dc[:, :, s0:s0 + bpm].sum((1, 2), dtype=torch.int64)
                        for (s0, bpm, *_rest) in specs], 1)


def _d1_prepare(lib, nat: torch.Tensor, plan) -> tuple:
    """The checks and allocations of a D1 call on nat [N, n_blocks, 64]:
    (the output int64 [N, ncomp], the components' (s0, bpm) as
    `jdt_dc_totals` takes them, the status words the launch needs past
    word 0, as the kernel's own `jdt_dc_totals_status_words` counts
    them)."""
    (n_mcus, _rows_d, _cols_d, plen), specs = plan.structured
    if nat.dtype != torch.int16 or nat.dim() != 3 \
            or nat.shape[1:] != (n_mcus * plen, 64) \
            or not nat.is_contiguous():
        raise ValueError(f"nat must be contiguous int16 [N, {n_mcus * plen}, "
                         f"64], got {nat.dtype} {tuple(nat.shape)}")
    ncomp = len(specs)
    out = torch.empty((nat.shape[0], ncomp), dtype=torch.int64,
                      device=nat.device)
    meta = (ctypes.c_longlong * (2 * ncomp))(
        *[v for (s0, bpm, *_rest) in specs for v in (s0, bpm)])
    words = lib.jdt_dc_totals_status_words(nat.shape[0], ncomp)
    return out, meta, words


def _d1_launch(lib, nat, plan, out, meta, status, stream) -> int:
    """One `jdt_dc_totals` call (the kernel's launch), its error code."""
    (n_mcus, _rows_d, _cols_d, plen), specs = plan.structured
    return lib.jdt_dc_totals(nat.data_ptr(), n_mcus, plen, nat.shape[0],
                             len(specs), meta, out.data_ptr(),
                             status.data_ptr(), status.numel() - 1, stream)


def _dc_totals_d1(nat: torch.Tensor, plan) -> torch.Tensor:
    if nat.dim() == 2:
        return _dc_totals_d1(nat[None], plan)[0]
    lib = _build.load()
    out, meta, words = _d1_prepare(lib, nat, plan)
    if nat.shape[0] == 0:
        return out
    dev = nat.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status, _epoch = _build.status_buffer("dc_totals", dev, stream, words,
                                              32)
        err = _d1_launch(lib, nat, plan, out, meta, status, stream)
        _build.count_launch("dc_totals")
    _build.check(lib, err, "dc_totals")
    return out


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
    device, built once per plan, and A1's: int32 stream_idx, raster_of (the
    raster block of each stream block j, or -1 where raster_src gives it
    none), seg_first and pad_rows (the raster blocks raster_src leaves
    zero), with its per-component geometry."""

    def __init__(self, plan, device):
        def put(a, dtype=np.int64):
            return torch.from_numpy(np.asarray(a, dtype)).to(device)

        self.stream_idx = [put(a) for a in plan.stream_idx]
        self.seg_first = [put(a) for a in plan.seg_first]
        self.raster_src = [put(a) for a in plan.raster_src]
        self.restart_interval = plan.restart_interval
        meta, self._a1_maps, ptrs = [], [], []
        for s_idx, first, src in zip(plan.stream_idx, plan.seg_first,
                                     plan.raster_src):
            n_c, src = len(s_idx), np.asarray(src, np.int64)
            live = src < n_c
            raster_of = np.full(n_c, -1, np.int32)
            raster_of[src[live]] = np.flatnonzero(live)
            pad = np.flatnonzero(~live)
            arrays = [put(a, np.int32) for a in (s_idx, raster_of, first,
                                                 pad)]
            self._a1_maps += arrays
            ptrs += [a.data_ptr() for a in arrays]
            meta.append((n_c, len(src), int(plan.restart_interval == 0), 0,
                         0, 0, 0, 0, 0, 0, 0, 0, 0, len(pad)))
        self.a1 = _A1Layout(meta, ptrs)


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
    (module docstring). CPU tensors run `assemble_nat_plain`, CUDA tensors
    kernel A1 (one launch), anything else raises."""
    if plan.structured is None and maps is None:
        raise ValueError("plan has no structured form; pass GeneralMaps")
    if nat.device.type == "cpu":
        return assemble_nat_plain(nat, plan, maps, carry)
    if nat.device.type != "cuda":
        raise ValueError(f"no A1 implementation for device {nat.device}")
    return _assemble_a1(nat, plan, maps, carry)


def assemble_nat_plain(nat: torch.Tensor, plan, maps: GeneralMaps = None,
                       carry=None) -> list:
    """Plain PyTorch version of A1: `assemble_structured` when the plan has
    the closed form, else `assemble_general`. Runs on any device; the CPU
    path and `chip_smoke.py`'s on-card comparison use it."""
    if plan.structured is not None:
        return assemble_structured(nat, plan, carry)
    if maps is None:
        raise ValueError("plan has no structured form; pass GeneralMaps")
    return assemble_general(nat, maps, carry)


class _A1Layout:
    """A1's per-component geometry of one plan (kCompMeta int64 each, as
    `jdt_assemble` takes it) and, on the general branch, the device
    pointers of its maps; kept alive with the plan or the maps."""

    def __init__(self, meta, ptrs=None):
        flat = [v for m in meta for v in m]
        self.meta = (ctypes.c_longlong * len(flat))(*flat)
        self.ptrs = None if ptrs is None else (ctypes.c_void_p * len(ptrs))(
            *ptrs)
        self.rows = tuple(m[1] for m in meta)
        self.data_tiles = sum(-(-m[0] // A1_ROWS) for m in meta)
        self.tiles = self.data_tiles + sum(-(-m[13] // A1_ROWS) for m in meta)


@lru_cache(maxsize=256)
def _structured_layout(plan) -> _A1Layout:
    (n_mcus, rows_d, cols_d, plen), specs = plan.structured
    return _A1Layout([
        (n_mcus * bpm, hc * wc, int(seg_blocks == 0), seg_blocks, plen, slot0,
         bpm, vs, hs, wc, cols_d, rows_d * vs, cols_d * hs,
         hc * wc - n_mcus * bpm)
        for slot0, bpm, vs, hs, hc, wc, seg_blocks in specs])


def _carry_args(carry, ncomp: int, n: int, dev) -> tuple:
    """The carry as A1 reads it, carry[c * sc + n * sn]: (the int64 tensor
    on `dev`, its pointer, sc, sn); (None, None, 0, 0) for none."""
    if carry is None:
        return None, None, 0, 0
    c = torch.as_tensor(carry).to(device=dev, dtype=torch.int64)
    if c.dim() == 1:
        c = c[:, None]
    if c.dim() != 2 or c.shape[0] != ncomp or c.shape[1] not in (1, n):
        raise ValueError(f"carry {tuple(c.shape)} must be [{ncomp}] or "
                         f"[{ncomp}, 1 or {n}]")
    return c, c.data_ptr(), c.stride(0), c.stride(1) if c.shape[1] > 1 else 0


def _a1_prepare(nat: torch.Tensor, plan, maps, carry) -> tuple:
    """The checks and allocations of an A1 call on nat [N, n_blocks, 64]:
    (layout, the output allocation, its per-component views, the carry as
    `_carry_args` gives it)."""
    if nat.dtype != torch.int16 or nat.dim() != 3 \
            or nat.shape[1:] != (plan.n_blocks, 64) \
            or not nat.is_contiguous() or nat.data_ptr() % 16:
        raise ValueError(f"nat must be contiguous int16 [N, {plan.n_blocks}, "
                         f"64] on a 16-byte boundary, got {nat.dtype} "
                         f"{tuple(nat.shape)}")
    if plan.structured is not None:
        layout = _structured_layout(plan)
    else:
        layout = maps.a1
        if maps.stream_idx and maps.stream_idx[0].device != nat.device:
            raise ValueError(f"GeneralMaps on {maps.stream_idx[0].device}, "
                             f"nat on {nat.device}")
    n = nat.shape[0]
    out = torch.empty(n * sum(layout.rows) * 64, dtype=torch.int16,
                      device=nat.device)
    stores, off = [], 0
    for rows in layout.rows:
        stores.append(out[off:off + n * rows * 64].view(n, rows, 64))
        off += n * rows * 64
    return layout, out, stores, _carry_args(carry, len(layout.rows), n,
                                            nat.device)


def _a1_launch(lib, nat, plan, layout, out, carry_args, status, epoch,
               stream) -> int:
    """One `jdt_assemble` call (the kernel's launch), its error code."""
    _carry, carry_ptr, carry_sc, carry_sn = carry_args
    return lib.jdt_assemble(
        nat.data_ptr(), plan.n_blocks, nat.shape[0], len(layout.rows),
        layout.meta, int(layout.ptrs is not None), layout.ptrs, carry_ptr,
        carry_sc, carry_sn, out.data_ptr(), status.data_ptr(),
        status.numel() - 1, epoch, stream)


def _assemble_a1(nat: torch.Tensor, plan, maps, carry) -> list:
    if nat.dim() == 2:
        return [s[0] for s in _assemble_a1(nat[None], plan, maps, carry)]
    layout, out, stores, carry_args = _a1_prepare(nat, plan, maps, carry)
    if nat.shape[0] == 0 or layout.tiles == 0:
        return stores
    dev = nat.device
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status, epoch = _build.status_buffer(
            "assemble", dev, stream, nat.shape[0] * layout.data_tiles, 32)
        err = _a1_launch(lib, nat, plan, layout, out, carry_args, status,
                         epoch, stream)
        _build.count_launch("assemble")
    _build.check(lib, err, "assemble")
    return stores

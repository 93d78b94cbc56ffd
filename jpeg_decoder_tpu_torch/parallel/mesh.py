"""Port of `jpeg_decoder_tpu/parallel/mesh.py`: the device mesh, and the
two exchanges the parallel axes need.

Axes:
- "data"   — batch data parallelism over images (DP). No exchange.
- "stripe" — MCU-row stripes within one image (SP): a 1-row halo
  exchange between neighbouring stripes, and the exclusive carry of one
  DC scalar per stripe and component.

The reference's mesh is one process driving every device of a
`jax.sharding.Mesh`, and so is this one: one Python caller places each
shard's work on its device and moves the few values that cross shards
with device-to-device copies. The reference's collectives become:
- `lax.ppermute` of one plane row per neighbour (`stripes.py:100-101`)
  -> `halo_rows`;
- `lax.all_gather` of one scalar per stripe and component
  (`device_scan.py:779-792`) -> `exclusive_carry`.
A mesh may name one device several times (the caller's `devices`): on a
machine with one card, a mesh of slots of `cuda:0` runs every shard on
that card, and the exchanges stay copies between the slots' tensors, as
between cards. `EXCHANGED` counts the bytes each exchange moved.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..params import DeviceParams
from ..transfer import checked_device

# Bytes moved by the exchanges, by kind: "halo" (`halo_rows`), "carry"
# (`exclusive_carry`) and "gather" (`gather_rows`); see reset_exchanged().
EXCHANGED = {"halo": 0, "carry": 0, "gather": 0}


def reset_exchanged() -> None:
    for name in EXCHANGED:
        EXCHANGED[name] = 0


class Mesh:
    """Devices on named axes: `devices` is a numpy object array of
    `torch.device` shaped by the axis sizes, `axis_names` their names and
    `shape` the ordered {name: size} dict, as on `jax.sharding.Mesh`.
    `params(device)` is the one `DeviceParams` of each distinct device."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self._params: dict = {}

    @property
    def first(self) -> torch.device:
        """The mesh's first device: where work that is not sharded runs
        (the reference's default device)."""
        return self.devices.flat[0]

    def params(self, device: torch.device) -> DeviceParams:
        params = self._params.get(device)
        if params is None:
            params = self._params[device] = DeviceParams(device)
        return params

    def axis_devices(self, *axes: str) -> np.ndarray:
        """The devices along `axes`, in that order, at index 0 of every
        other axis: an object array shaped by those axes' sizes (the
        shards of a `PartitionSpec(*axes)`; other axes replicate)."""
        for name in axes:
            if name not in self.shape:
                raise ValueError(f"mesh has no axis {name!r}: "
                                 f"{self.axis_names}")
        sub = self.devices[tuple(slice(None) if n in axes else 0
                                 for n in self.axis_names)]
        kept = [n for n in self.axis_names if n in axes]
        return np.transpose(sub, [kept.index(a) for a in axes])


def make_mesh(axis_sizes: dict, devices: Optional[Sequence] = None) -> Mesh:
    """A Mesh with the given {axis_name: size} (insertion order = axis
    order). `devices` defaults to every CUDA device; without CUDA the
    caller must pass them (there is no CPU default). The sizes must
    multiply to at most len(devices); the first that many are used. A
    caller's `devices` may repeat a device: ["cpu"] * 8 in the CPU tests,
    ["cuda:0"] * 4 on a machine with one card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(e.g. ['cpu'] * n) to build a mesh without "
                               "one")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = int(np.prod(list(axis_sizes.values())))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        dev = checked_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        arr[i] = dev
    return Mesh(arr.reshape(tuple(axis_sizes.values())),
                tuple(axis_sizes.keys()))


def mesh_device(mesh: Mesh, device="cuda") -> torch.device:
    """The device a mesh's caller runs its unsharded work on: the mesh's
    first. `device` (an entry point's own argument, "cuda" by default) must
    be that default or name the same device."""
    if torch.device(device) not in (torch.device("cuda"), mesh.first):
        raise ValueError(f"device {device!r} with a mesh: the mesh's "
                         f"devices place the work, its first is "
                         f"{mesh.first}")
    return mesh.first


def _copy_to(t: torch.Tensor, device: torch.device, kind: str
             ) -> torch.Tensor:
    """A copy of `t` on `device`, also when it is there already: the
    exchange between two slots of one device is still a copy."""
    EXCHANGED[kind] += t.numel() * t.element_size()
    return t.to(device, non_blocking=True, copy=True)


def halo_rows(planes: list) -> list:
    """The 1-row halo of planes [..., rows, cols] held one per stripe, each
    on its stripe's device: per stripe (top, bottom), the last row of the
    stripe above and the first row of the stripe below, copied to this
    stripe's device; zeros where there is no neighbour, as `lax.ppermute`
    leaves a device that nothing sends to."""
    out = []
    for d, plane in enumerate(planes):
        zero = plane.new_zeros((*plane.shape[:-2], 1, plane.shape[-1]))
        top = (_copy_to(planes[d - 1][..., -1:, :], plane.device, "halo")
               if d > 0 else zero)
        bot = (_copy_to(planes[d + 1][..., :1, :], plane.device, "halo")
               if d + 1 < len(planes) else zero)
        out.append((top, bot))
    return out


def exclusive_carry(totals: list) -> list:
    """Per shard, the sum of the values of every earlier shard along the
    axis, on that shard's device: `totals[d]` is shard d's tensor (any
    shape, the same for all), and the result's d-th entry sums totals[:d]
    (zeros for the first), the reference's all_gather + masked sum. Sums
    in the dtype given: int64 for DC, whose store narrowing wraps mod 2^16
    as the reference's int32 does."""
    out = []
    for d, t in enumerate(totals):
        acc = torch.zeros_like(t)
        for e in range(d):
            acc = acc + _copy_to(totals[e], t.device, "carry")
        out.append(acc)
    return out


def gather_rows(parts: list, device: torch.device, dim: int = 0
                ) -> torch.Tensor:
    """Shards' tensors concatenated along `dim` on `device`: the rows of a
    row-sharded result gathered on one device, one copy per shard."""
    shape = list(parts[0].shape)
    shape[dim] = sum(p.shape[dim] for p in parts)
    out = parts[0].new_empty(shape, device=device)
    off = 0
    for p in parts:
        EXCHANGED["gather"] += p.numel() * p.element_size()
        out.narrow(dim, off, p.shape[dim]).copy_(p, non_blocking=True)
        off += p.shape[dim]
    return out

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
between cards. `EXCHANGED` counts the bytes each exchange moved (through
`_build.count`: a replay of a captured line adds what its capture
recorded).

A mesh may also span processes, as the reference's does under
`jax.distributed` (`jpeg_decoder_tpu/parallel/mesh.py:6-8`): `make_mesh`
under a process group (`dist.init_process_mesh`) gathers every rank's
local devices, ordered by rank, and `owners` gives the rank of each
entry. Each rank then runs only the shards it holds, and the exchanges
take only this rank's tensors plus the owners of the line they run
along: between two of this rank's entries they copy as above, between
ranks they go through `dist.Transport` (host-staged gloo), and `CROSSED`
counts, by the same kinds, the bytes this rank received from other
ranks. A mesh built without a process group has every owner 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import _build
from ..params import DeviceParams
from ..transfer import checked_device
from . import dist

# Bytes moved by the exchanges into this process's tensors, by kind: "halo"
# (`halo_rows`), "carry" (`exclusive_carry`) and "gather" (`gather_rows`);
# CROSSED the part of them that came from another process. See
# reset_exchanged().
EXCHANGED = {"halo": 0, "carry": 0, "gather": 0}
CROSSED = {"halo": 0, "carry": 0, "gather": 0}


def reset_exchanged() -> None:
    for name in EXCHANGED:
        EXCHANGED[name] = 0
        CROSSED[name] = 0


class Mesh:
    """Devices on named axes: `devices` is a numpy object array of
    `torch.device` shaped by the axis sizes, `axis_names` their names and
    `shape` the ordered {name: size} dict, as on `jax.sharding.Mesh`.
    `owners` (same shape) holds the rank of the process each entry belongs
    to, `rank` this process's and `processes` the number of processes the
    mesh was built across (1 without a process group; entries of other
    ranks name their devices as those ranks see them). `params(device)` is
    the one `DeviceParams` of each distinct local device."""

    def __init__(self, devices: np.ndarray, axis_names: tuple,
                 owners: Optional[np.ndarray] = None, rank: int = 0,
                 processes: int = 1):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.owners = (np.zeros(devices.shape, np.int64) if owners is None
                       else owners)
        self.rank = rank
        self.processes = processes
        self._params: dict = {}

    @property
    def first(self) -> torch.device:
        """This process's first device of the mesh: where work that is not
        sharded runs (the reference's default device)."""
        local = self.devices[self.owners == self.rank]
        if not local.size:
            raise ValueError(f"process {self.rank} holds no device of this "
                             "mesh")
        return local[0]

    def is_local(self, index) -> bool:
        """Whether the entry at `index` (into `devices`) is this
        process's."""
        return bool(self.owners[index] == self.rank)

    def params(self, device: torch.device) -> DeviceParams:
        params = self._params.get(device)
        if params is None:
            params = self._params[device] = DeviceParams(device)
        return params

    def axis_devices(self, *axes: str) -> np.ndarray:
        """The devices along `axes`, in that order, at index 0 of every
        other axis: an object array shaped by those axes' sizes (the
        shards of a `PartitionSpec(*axes)`; other axes replicate)."""
        return self._along(self.devices, axes)

    def axis_owners(self, *axes: str) -> np.ndarray:
        """The owners of `axis_devices(*axes)`, in the same shape."""
        return self._along(self.owners, axes)

    def _along(self, arr: np.ndarray, axes: tuple) -> np.ndarray:
        for name in axes:
            if name not in self.shape:
                raise ValueError(f"mesh has no axis {name!r}: "
                                 f"{self.axis_names}")
        sub = arr[tuple(slice(None) if n in axes else 0
                        for n in self.axis_names)]
        kept = [n for n in self.axis_names if n in axes]
        return np.transpose(sub, [kept.index(a) for a in axes])


def make_mesh(axis_sizes: dict, devices: Optional[Sequence] = None) -> Mesh:
    """A Mesh with the given {axis_name: size} (insertion order = axis
    order). `devices` defaults to every CUDA device; without CUDA the
    caller must pass them (there is no CPU default). The sizes must
    multiply to at most len(devices); the first that many are used. A
    caller's `devices` may repeat a device: ["cpu"] * 8 in the CPU tests,
    ["cuda:0"] * 4 on a machine with one card.

    Under a process group (`dist.init_process_mesh`), `devices` are this
    process's own, and the mesh takes its entries from every rank's,
    gathered and ordered by rank (as `jax.devices()` orders them by
    process): every rank must call make_mesh with the same sizes."""
    if devices is None:
        devices = cuda_devices()
    n = int(np.prod(list(axis_sizes.values())))
    shape = tuple(axis_sizes.values())
    if not dist.initialized():
        if n > len(devices):
            raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
        arr = np.empty(n, dtype=object)
        for i, d in enumerate(devices[:n]):
            arr[i] = checked_device(d)
        return Mesh(arr.reshape(shape), tuple(axis_sizes.keys()))
    local = [checked_device(d) for d in devices]
    everyone = dist.gather_objects([str(d) for d in local])
    entries = [(r, i) for r, names in enumerate(everyone)
               for i in range(len(names))]
    if n > len(entries):
        raise ValueError(f"mesh needs {n} devices, the {len(everyone)} "
                         f"processes have {len(entries)}")
    me = dist.current_rank()
    arr = np.empty(n, dtype=object)
    owners = np.empty(n, np.int64)
    for k, (r, i) in enumerate(entries[:n]):
        arr[k] = local[i] if r == me else torch.device(everyone[r][i])
        owners[k] = r
    return Mesh(arr.reshape(shape), tuple(axis_sizes.keys()),
                owners.reshape(shape), me, len(everyone))


def cuda_devices() -> list:
    """This process's CUDA devices, the default `devices` of a mesh; raises
    without CUDA (a mesh has no CPU default)."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                           "(e.g. ['cpu'] * n) to build a mesh without one")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


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
    _build.count(EXCHANGED, kind, t.numel() * t.element_size())
    return t.to(device, non_blocking=True, copy=True)


def _crossed(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Count `t`, received from another process, in EXCHANGED and
    CROSSED."""
    nbytes = t.numel() * t.element_size()
    EXCHANGED[kind] += nbytes
    CROSSED[kind] += nbytes
    return t


def _line(items: list, owners) -> tuple:
    """(owners, this rank, {position: item}) of a line of the mesh of
    which `items` are this process's entries, in order; `owners` is the
    rank of every position along the line (a row of `Mesh.axis_owners`),
    or None for a line all of whose entries are this process's."""
    if owners is None:
        return [0] * len(items), 0, dict(enumerate(items))
    owners = [int(o) for o in owners]
    at = local_positions(owners)
    if len(at) != len(items):
        raise ValueError(f"{len(items)} tensors for the {len(at)} entries "
                         "this process holds on the line")
    return owners, dist.current_rank(), dict(zip(at, items))


def local_positions(owners) -> list:
    """The positions along a line of the mesh (`owners`: the rank of each)
    that this process holds, in order."""
    me = dist.current_rank()
    return [p for p, o in enumerate(owners) if int(o) == me]


def halo_rows(planes: list, owners=None) -> list:
    """The 1-row halo of planes [..., rows, cols] held one per stripe, each
    on its stripe's device: per stripe (top, bottom), the last row of the
    stripe above and the first row of the stripe below, copied to this
    stripe's device; zeros where there is no neighbour, as `lax.ppermute`
    leaves a device that nothing sends to. With `owners` (the rank of each
    stripe), `planes` are this process's stripes and the rows of a
    neighbour in another process cross through the transport; every
    stripe's plane has the same shape."""
    owners, me, at = _line(planes, owners)
    n = len(owners)
    last, first = slice(-1, None), slice(0, 1)
    like = planes[0] if planes else None
    ex = dist.Transport()
    slot = {}
    for p in range(n - 1):      # one order on every rank: down, then up
        for src, dst, rows in ((p, p + 1, last), (p + 1, p, first)):
            if owners[src] == owners[dst]:
                continue
            if owners[src] == me:
                ex.send_to(at[src][..., rows, :], owners[dst])
            elif owners[dst] == me:
                slot[src, dst] = ex.recv_from(
                    (*like.shape[:-2], 1, like.shape[-1]), like.dtype,
                    owners[src], at[dst].device)
    got = ex.run()

    def edge(src: int, dst: int, rows: slice) -> torch.Tensor:
        plane = at[dst]
        if not 0 <= src < n:
            return plane.new_zeros((*plane.shape[:-2], 1, plane.shape[-1]))
        if src in at:
            return _copy_to(at[src][..., rows, :], plane.device, "halo")
        return _crossed(got[slot[src, dst]], "halo")

    return [(edge(p - 1, p, last), edge(p + 1, p, first)) for p in at]


def exclusive_carry(totals: list, owners=None) -> list:
    """Per shard, the sum of the values of every earlier shard along the
    axis, on that shard's device: `totals[d]` is shard d's tensor (any
    shape, the same for all), and the result's d-th entry sums totals[:d]
    (zeros for the first), the reference's all_gather + masked sum. Sums
    in the dtype given: int64 for DC, whose store narrowing wraps mod 2^16
    as the reference's int32 does. With `owners` (the rank of each shard),
    `totals` are this process's shards, and each earlier shard of another
    process crosses once to this process, in the dtype given."""
    owners, me, at = _line(totals, owners)
    n = len(owners)
    like = totals[0] if totals else None
    ex = dist.Transport()
    slot = {}
    for e in range(n):          # shard e to every later shard's process
        for r in sorted({owners[d] for d in range(e + 1, n)} - {owners[e]}):
            if owners[e] == me:
                ex.send_to(at[e], r)
            elif r == me:
                slot[e] = ex.recv_from(like.shape, like.dtype, owners[e],
                                       "cpu")
    got = ex.run()
    for i in slot.values():
        CROSSED["carry"] += got[i].numel() * got[i].element_size()
    out = []
    for d, t in at.items():
        parts = [_copy_to(at[e] if e in at else got[slot[e]], t.device,
                          "carry") for e in range(d)]
        out.append(torch.stack(parts).sum(0, dtype=t.dtype) if parts
                   else torch.zeros_like(t))
    return out


def gather_rows(parts: list, device: torch.device, dim: int = 0,
                owners=None) -> torch.Tensor:
    """Shards' tensors concatenated along `dim` on `device`: the rows of a
    row-sharded result gathered on one device, one copy per shard. With
    `owners` (the rank of each shard), `parts` are this process's shards,
    and every process of the line gathers the whole on its `device`: each
    shard's shape, then its data, cross to every other process."""
    owners, me, at = _line(parts, owners)
    n = len(owners)
    like = parts[0]
    ranks = sorted(set(owners))

    def round_trip(payload, shape_of, dtype, dest) -> dict:
        ex = dist.Transport()
        slot = {}
        for p in range(n):      # shard p to every other process, in order
            for r in ranks:
                if r == owners[p] or shape_of(p) is None:
                    continue
                if owners[p] == me:
                    ex.send_to(payload(p), r)
                elif r == me:
                    slot[p] = ex.recv_from(shape_of(p), dtype, owners[p],
                                           dest)
        got = ex.run()
        return {p: got[i] for p, i in slot.items()}

    shapes = {p: tuple(t.shape) for p, t in at.items()}
    shapes.update({p: tuple(int(x) for x in t) for p, t in round_trip(
        lambda p: torch.tensor(at[p].shape, dtype=torch.int64),
        lambda p: (like.dim(),), torch.int64, "cpu").items()})
    remote = round_trip(lambda p: at[p],
                        lambda p: shapes[p] if np.prod(shapes[p]) else None,
                        like.dtype, device)
    shape = list(like.shape)
    shape[dim] = sum(shapes[p][dim] for p in range(n))
    out = like.new_empty(shape, device=device)
    off = 0
    for p in range(n):
        rows = shapes[p][dim]
        if p in at:
            _build.count(EXCHANGED, "gather",
                         at[p].numel() * at[p].element_size())
            out.narrow(dim, off, rows).copy_(at[p], non_blocking=True)
        elif p in remote:
            out.narrow(dim, off, rows).copy_(_crossed(remote[p], "gather"),
                                             non_blocking=True)
        off += rows
    return out

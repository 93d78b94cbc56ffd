"""The process group of a mesh that spans processes, and the transport
its exchanges use between processes.

The reference runs one mesh over several processes for free: under
`jax.distributed`, `jax.devices()` spans every process and the same mesh
code shards over them (`jpeg_decoder_tpu/parallel/mesh.py:6-8`). Here a
process joins the group with `init_process_mesh` (gloo over TCP), and
`mesh.make_mesh` then gathers every rank's local devices into one mesh,
ordered by rank. Each rank runs the shards its devices hold; the few
values that cross shards (`mesh.halo_rows`, `exclusive_carry`,
`gather_rows`) go between ranks through `Transport`.

gloo's send and receive take CPU tensors only, so a CUDA tensor crosses
as a copy to the host, the send, and a copy to the receiver's device.
NCCL is not used: it refuses two ranks on one card, and the machine the
port is measured on has one.

`Shard` is the counterpart of an entry of `jax.Array.addressable_shards`:
what a rank holds of a global result. `Remote` stands in the place of an
image another rank holds (not None, which means `on_error` in
`DeviceStreamDecoder.decode_stream`).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Shard:
    """A slice of a global result and this rank's data for it: `index` a
    tuple of slices into the global array (batch rows, then image rows
    where a result is striped), `data` the tensor on its device (a numpy
    array from the entry points that return numpy)."""
    index: tuple
    data: Any


@dataclasses.dataclass(frozen=True)
class Remote:
    """The place of an image that rank `rank` holds."""
    rank: int


def init_process_mesh(rank: int, world_size: int, init_method: str,
                      timeout_s: float = 120.0) -> None:
    """Join the gloo process group of `world_size` ranks as `rank`.
    `init_method` is "tcp://127.0.0.1:<port>" (rank 0 listens there); every
    later collective or transfer that waits longer than `timeout_s` raises
    instead of hanging."""
    dist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the process group joined by `init_process_mesh`."""
    if initialized():
        dist.destroy_process_group()


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def current_rank() -> int:
    """This process's rank, 0 outside a process group."""
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    """The number of processes in the group, 1 outside one."""
    return dist.get_world_size() if initialized() else 1


def gather_objects(obj) -> list:
    """Every rank's `obj` (picklable), in rank order; a collective: every
    rank calls it."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


class Transport:
    """One round of point-to-point transfers between ranks.

    Every rank enumerates the round's transfers in one global order that
    it derives from the mesh, and calls `send_to` for those it sends and
    `recv_from` for those it receives, in that order; `run` then posts
    them all at once (`dist.batch_isend_irecv`) and waits. The k-th
    message from rank a to rank b carries tag k on both ends, so no pair
    of ranks can wait on each other in a cycle (isolated sends and
    receives posted in rank-local order deadlock on a ring)."""

    def __init__(self):
        self._ops: list = []
        self._recvs: list = []       # (host buffer, destination device)
        self._tags: dict = {}        # (src, dst) -> messages so far
        self._me = current_rank()

    def _tag(self, src: int, dst: int) -> int:
        tag = self._tags.get((src, dst), 0)
        self._tags[src, dst] = tag + 1
        return tag

    def send_to(self, t: torch.Tensor, rank: int) -> None:
        """Send `t` to `rank`, staged through a host copy."""
        host = t.detach().to("cpu").contiguous()
        self._ops.append(dist.P2POp(dist.isend, host, rank,
                                    tag=self._tag(self._me, rank)))

    def recv_from(self, shape, dtype, rank: int, device) -> int:
        """Receive a `shape` `dtype` tensor from `rank`, to land on
        `device`; returns its position in `run`'s result."""
        host = torch.empty(tuple(shape), dtype=dtype)
        self._ops.append(dist.P2POp(dist.irecv, host, rank,
                                    tag=self._tag(rank, self._me)))
        self._recvs.append((host, torch.device(device)))
        return len(self._recvs) - 1

    def run(self) -> list:
        """Post every transfer, wait for all, and return the received
        tensors, each on its device, in `recv_from` order."""
        if self._ops:
            for work in dist.batch_isend_irecv(self._ops):
                work.wait()
        return [host.to(device) for host, device in self._recvs]

"""Port of `jpeg_decoder_tpu/parallel/batch.py`: batch data parallelism,
a batch of same-geometry images split over the mesh's "data" axis.

The serving axis the reference decoder lacks (one decoder, one image,
`/root/reference/src/decoder.rs:101-131`): the coefficient stores of B
images are stacked on a leading batch axis and split over the data axis
as `PartitionSpec("data")` splits them, contiguous blocks of B / n_data
images, and each device reconstructs its block with the port's batched
reconstruction (`ops/pipeline.py::reconstruct`, every op once for the
block: kernel K2 at precision "fast", kernel E1, the exact int32 IDCT,
at "exact").
DP needs no exchange between devices. The geometry buckets images as
production services do (size class, sampling, scale).
"""

from __future__ import annotations

import numpy as np

from ..models import graphs
from ..ops.pipeline import reconstruct
from ..transfer import put
from .dist import Shard
from .stripes import _shards


def make_batch_pipeline(geometry, mesh, data_axis: str = "data"):
    """The batched reconstruction of `geometry` over `mesh`. Returns
    fn(stores, qts, batch=None) -> list of uint8 [b, H, W(, C)] tensors,
    one per data shard that holds images, each on its shard's device (the
    reference's array sharded on B), where `stores` is a tuple of int16
    [B, N_i, 64] numpy arrays per component and `qts` one tuple of
    uint16 [64] tables shared by every image.

    `stores` may instead be `rows_of(b0, b1)`, which returns those arrays'
    rows [b0, b1) (then `batch` gives B): a shard's rows are staged only
    where the shard runs, the counterpart of the reference harness's
    `piece_of` (`tools/multiproc_mesh.py:51-63`). On a mesh across
    processes only this process's shards run, and fn returns its `Shard`s
    (index (rows,)).

    Each shard's stores and tables land in its `graphs.recon_key`'s graph
    of the process's cache of its device (`graphs.device_graphs`),
    replayed from the key's second call (the first dispatches eagerly:
    one `put`, `reconstruct`); the shards of one device share its cache
    and their key."""
    devices = list(mesh.axis_devices(data_axis))
    owners = mesh.axis_owners(data_axis)

    def run(stores, qts, batch: int = None):
        if callable(stores):
            rows_of = stores
        else:
            stores = [np.asarray(s) for s in stores]
            batch = stores[0].shape[0]

            def rows_of(b0, b1):
                return tuple(s[b0:b1] for s in stores)
        parts = []
        for k, (dev, (b0, b1)) in enumerate(zip(
                devices, _shards(batch, len(devices)))):
            if b1 <= b0 or owners[k] != mesh.rank:
                continue
            shard = tuple(rows_of(b0, b1))
            qts_b = [tuple(qts)] * (b1 - b0)
            fill = graphs.recon_fill(graphs.device_graphs(dev), geometry,
                                     shard, qts_b)
            if fill is not None:
                out = fill.run()
            else:
                out = reconstruct(geometry, list(put(shard, dev)), qts_b,
                                  mesh.params(dev))
            parts.append(out if mesh.processes == 1
                         else Shard((slice(b0, b1),), out))
        return parts

    return run


def decode_batch_sharded(geometry, stores_batched, qts, mesh,
                         data_axis: str = "data"):
    """Decode B same-geometry images split over the data axis.

    stores_batched: np.int16 [B, N_i, 64] per component; qts: np.uint16[64]
    per component. Returns np.uint8 [B, H, W, C] (or [B, H, W]); on a mesh
    across processes, this process's rows as `Shard`s (index (rows,),
    numpy data)."""
    fn = make_batch_pipeline(geometry, mesh, data_axis)
    parts = fn(tuple(stores_batched), tuple(np.asarray(q) for q in qts))
    if mesh.processes > 1:
        return [Shard(p.index, p.data.cpu().numpy()) for p in parts]
    return np.concatenate([p.cpu().numpy() for p in parts])

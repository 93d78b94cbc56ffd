"""Port of `jpeg_decoder_tpu/parallel/batch.py`: batch data parallelism,
a batch of same-geometry images split over the mesh's "data" axis.

The serving axis the reference decoder lacks (one decoder, one image,
`/root/reference/src/decoder.rs:101-131`): the coefficient stores of B
images are stacked on a leading batch axis and split over the data axis
as `PartitionSpec("data")` splits them, contiguous blocks of B / n_data
images, and each device reconstructs its block with the port's batched
reconstruction (`ops/pipeline.py::reconstruct`, every op once for the
block: kernel K2 at precision "fast", the exact int32 IDCT at "exact").
DP needs no exchange between devices. The geometry buckets images as
production services do (size class, sampling, scale).
"""

from __future__ import annotations

import numpy as np

from ..ops.pipeline import reconstruct
from ..transfer import put
from .stripes import _shards


def make_batch_pipeline(geometry, mesh, data_axis: str = "data"):
    """The batched reconstruction of `geometry` over `mesh`. Returns
    fn(stores, qts) -> list of uint8 [b, H, W(, C)] tensors, one per data
    shard that holds images, each on its shard's device (the reference's
    array sharded on B), where `stores` is a tuple of int16 [B, N_i, 64]
    numpy arrays per component and `qts` one tuple of uint16 [64] tables
    shared by every image."""
    devices = list(mesh.axis_devices(data_axis))

    def run(stores, qts):
        stores = [np.asarray(s) for s in stores]
        parts = []
        for dev, (b0, b1) in zip(devices, _shards(stores[0].shape[0],
                                                  len(devices))):
            if b1 <= b0:
                continue
            local = put(tuple(s[b0:b1] for s in stores), dev)
            parts.append(reconstruct(geometry, list(local),
                                     [tuple(qts)] * (b1 - b0),
                                     mesh.params(dev)))
        return parts

    return run


def decode_batch_sharded(geometry, stores_batched, qts, mesh,
                         data_axis: str = "data") -> np.ndarray:
    """Decode B same-geometry images split over the data axis.

    stores_batched: np.int16 [B, N_i, 64] per component; qts: np.uint16[64]
    per component. Returns np.uint8 [B, H, W, C] (or [B, H, W])."""
    fn = make_batch_pipeline(geometry, mesh, data_axis)
    return np.concatenate([p.cpu().numpy() for p in fn(
        tuple(stores_batched), tuple(np.asarray(q) for q in qts))])

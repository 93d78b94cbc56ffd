"""Batch decode service on PyTorch: host entropy workers feeding the device
reconstruction.

Port of `jpeg_decoder_tpu/models/service.py` (`BatchDecodeService`,
`decode_many`): a pool of host threads runs the bit-serial entropy stage
(the port's host copy, `Decoder(backend="numpy")`; its C++ engine
releases the GIL), then the images are bucketed by geometry, as in the
reference:
- with a `mesh` (`parallel.make_mesh`), a bucket of more than one image
  whose quantization tables are all equal decodes in one data-parallel
  batch over the mesh's "data" axis (`parallel/batch.py::
  decode_batch_sharded`);
- every other image is reconstructed alone through the `Decoder`'s
  device path (`decoder.reconstruct_on_device`: one H2D copy per
  component store, kernel K2 or the exact IDCT by the geometry's
  precision, upsampling, color, one copy back), on `device`, or on the
  mesh's first device.
Results are numpy arrays in source order. The reference's staging builds
the geometry at its default precision, "exact", so the service's images
are bit-equal to the host decode.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Sequence

import numpy as np

from ..decoder import reconstruct_on_device
from ..host.decoder import Decoder
from ..host.ops.pipeline import geometry_from_frame, reconstruct_image
from ..parallel.batch import decode_batch_sharded
from ..parallel.mesh import mesh_device
from ..transfer import checked_device

BACKENDS = ("torch", "numpy")


def _host_stage(source, scale_to=None):
    """Run parse + entropy for one image; return (geometry, stores, qts)."""
    d = Decoder(source, backend="numpy")
    if scale_to is not None:
        d.scale(*scale_to)
    d._decode_entropy_only()
    n = len(d.frame.components)
    stores = [d._pending_render[i][0].reshape(-1, 64) for i in range(n)]
    qts = [d._pending_render[i][1] for i in range(n)]
    transform = None if n == 1 else d._determine_color_transform()
    return geometry_from_frame(d.frame, transform), stores, qts


class BatchDecodeService:
    """Decode many images: threaded host entropy + device reconstruction on
    `device` ("cuda" by default; "cpu" when the caller asks for it), or
    over `mesh` (`device` then stays at its default or names the mesh's
    first device, where the unsharded images go). backend "numpy"
    reconstructs on the host instead (a mesh's buckets still decode on the
    mesh, as the reference's do whatever its backend)."""

    def __init__(self, mesh=None, host_threads: int = 4,
                 backend: str = "torch", *, device="cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of "
                             f"{BACKENDS}")
        if mesh is not None and mesh.processes > 1:
            raise NotImplementedError(
                "BatchDecodeService on a mesh across processes is not "
                "ported (the rest of ROADMAP item 16): pass a mesh of this "
                "process's devices")
        self.mesh = mesh
        self.host_threads = host_threads
        self.backend = backend
        self.device = None
        if mesh is not None:
            self.device = mesh_device(mesh, device)
        elif backend == "torch":
            self.device = checked_device(device)

    def decode_all(self, sources: Sequence, scale_to=None):
        """Decode all sources; returns list of np.uint8 arrays (order preserved)."""
        with cf.ThreadPoolExecutor(max_workers=self.host_threads) as pool:
            staged = list(pool.map(lambda s: _host_stage(s, scale_to), sources))

        buckets: dict = {}
        for idx, (geometry, stores, qts) in enumerate(staged):
            buckets.setdefault(geometry, []).append((idx, stores, qts))
        results: list = [None] * len(staged)
        for geometry, items in buckets.items():
            qts0 = items[0][2]
            if self.mesh is not None and len(items) > 1 and all(
                    all(np.array_equal(a, b) for a, b in zip(qts0, qts))
                    for _idx, _stores, qts in items):
                batched = [np.stack([stores[c] for _i, stores, _q in items])
                           for c in range(len(geometry.components))]
                out = decode_batch_sharded(geometry, batched, qts0, self.mesh)
                for (idx, _s, _q), img in zip(items, out):
                    results[idx] = img
                continue
            for idx, stores, qts in items:
                results[idx] = (
                    reconstruct_image(geometry, stores, qts)
                    if self.backend == "numpy" else
                    reconstruct_on_device(geometry, stores, qts, self.device))
        return results


def decode_many(sources: Sequence, mesh=None, host_threads: int = 4,
                backend: str = "torch", *, device="cuda"):
    return BatchDecodeService(mesh, host_threads, backend,
                              device=device).decode_all(sources)

"""Batch decode service on PyTorch: host entropy workers feeding the device
reconstruction.

Port of `jpeg_decoder_tpu/models/service.py` (`BatchDecodeService`,
`decode_many`) on one device: a pool of host threads runs the bit-serial
entropy stage (the port's host copy, `Decoder(backend="numpy")`; its C++
engine releases the GIL), then each image is reconstructed as the
reference does without a mesh: one image at a time, here through the
`Decoder`'s device path (`decoder.reconstruct_on_device`: one H2D copy per
component store, kernel K2 or the exact IDCT by the geometry's precision,
upsampling, color, one copy back), results as numpy arrays in source
order. The reference's staging builds the geometry at its default
precision, "exact", so the service's images are bit-equal to the host
decode.

The reference's mesh-sharded batches (`parallel/batch.py`) are ROADMAP
item 14: a `mesh` raises.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Sequence

from ..decoder import reconstruct_on_device
from ..host.decoder import Decoder
from ..host.ops.pipeline import geometry_from_frame, reconstruct_image
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
    `device` ("cuda" by default; "cpu" when the caller asks for it).
    backend "numpy" reconstructs on the host instead."""

    def __init__(self, mesh=None, host_threads: int = 4,
                 backend: str = "torch", *, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded batches are ROADMAP item 14 (the parallel "
                "axes on torch.distributed), not ported yet")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of "
                             f"{BACKENDS}")
        self.host_threads = host_threads
        self.backend = backend
        self.device = checked_device(device) if backend == "torch" else None

    def decode_all(self, sources: Sequence, scale_to=None):
        """Decode all sources; returns list of np.uint8 arrays (order preserved)."""
        with cf.ThreadPoolExecutor(max_workers=self.host_threads) as pool:
            staged = list(pool.map(lambda s: _host_stage(s, scale_to), sources))
        if self.backend == "numpy":
            return [reconstruct_image(geometry, stores, qts)
                    for geometry, stores, qts in staged]
        return [reconstruct_on_device(geometry, stores, qts, self.device)
                for geometry, stores, qts in staged]


def decode_many(sources: Sequence, mesh=None, host_threads: int = 4,
                backend: str = "torch", *, device="cuda"):
    return BatchDecodeService(mesh, host_threads, backend,
                              device=device).decode_all(sources)

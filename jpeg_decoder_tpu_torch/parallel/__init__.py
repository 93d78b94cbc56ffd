"""Port of `jpeg_decoder_tpu/parallel/`: the scaling axes over a mesh of
devices.

The reference decoder's execution tier is single-host threads (component
threads, block parallelism, row-parallel upsample + color); on the device
those intra-image axes are array dimensions of the batched kernels in
`..ops`. This package provides the axes the reference cannot:

- `batch`: data-parallel decode of image batches over the mesh's "data"
  axis (DP: one block of images per device).
- `stripes`: one large image's MCU rows over the "stripe" axis with a
  1-row halo exchange for the V2 chroma upsamplers (SP); `stripe_bits`
  the same with the entropy decode included (the DC seam carry).
- `mesh`: the mesh of `torch.device`s and its exchanges, device-to-device
  copies enqueued by one caller (one process, as in the reference), or
  across processes (`dist`: a gloo process group, host-staged transfers
  between ranks, `Shard` and `Remote`).
- `dryrun`: `dryrun_multichip`, DP, SP and DP x SP checked end to end.
"""

from .batch import decode_batch_sharded, make_batch_pipeline
from .mesh import Mesh, make_mesh
from .stripes import decode_striped, decode_striped_batch, make_stripe_pipeline

__all__ = [
    "Mesh",
    "make_mesh",
    "decode_batch_sharded",
    "make_batch_pipeline",
    "decode_striped",
    "decode_striped_batch",
    "make_stripe_pipeline",
]

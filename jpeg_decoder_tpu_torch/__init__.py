"""jpeg_decoder_tpu_torch: the JPEG decode engine on PyTorch and CUDA.

A port of `jpeg_decoder_tpu` (JAX on a TPU) to PyTorch with kernels written
by hand for NVIDIA Hopper (H100, sm_90a). It covers the stream decoder,
`DeviceStreamDecoder`: every JPEG the reference's decodes, one image at a
time or, with `decode_stream(batch_size=N)`, in groups of up to N that
share each kernel launch (one Huffman sweep, one IDCT launch, one tail
launch per group).
- Baseline JPEGs on the "bits" interchange: host prescan, the 4 B/chunk
  delta wire (or the 12 B/chunk anchor wire for scans it declines, such
  as more than two table pairs), chunk-parallel Huffman decode on the
  device.
- Progressive and quirk streams: a host decode, transcoded onto the same
  wire.
- The "prefix" interchange (host-decoded zigzag prefixes and residuals).
- Lossless (SOF3): host difference planes, predictors on the device.
- Precision "fast" (fp32 IDCT) or "exact" (int32, bit-equal to the
  reference), in the layouts "interleaved" ([H, W, C]), "planar"
  ([C, H, W]) and "planar-pallas" ([C, H, W] through the fused tail K3).

    from jpeg_decoder_tpu_torch import DeviceStreamDecoder
    with DeviceStreamDecoder() as dec:                   # on "cuda"
        images = dec.decode_stream(list_of_jpeg_bytes)   # CUDA tensors
        images = dec.decode_stream(list_of_jpeg_bytes, batch_size=16)

The public API of the reference is here too: `Decoder` (the reference's
`Decoder` with `backend="torch"`, on "cuda" by default: the entropy stage
on the host, the reconstruction on the card, numpy out), the batch
service `BatchDecodeService` / `decode_many`, and `StageTimer`, which
`DeviceStreamDecoder(timer=...)` and `Decoder(timer=...)` fill per stage.

    from jpeg_decoder_tpu_torch import Decoder
    pixels = Decoder(jpeg_bytes, precision="fast").decode_array()

The host stage is the port's own copy of the JAX package's numpy/C++ code
(`jpeg_decoder_tpu_torch.host`); neither JAX nor the JAX package is ever
imported. Kernels:
- K1 `entropy/chunk_decode.py::decode_chunks` (csrc/huffman_decode.cu)
- K2 `ops/kernels.py::dequant_idct` (csrc/dequant_idct.cu)
- K3 `ops/kernels.py::fused_tail` (csrc/fused_tail.cu), layout
  "planar-pallas"
- K4 `ops/kernels.py::fused_recon` (csrc/fused_recon.cu), driven by
  tools/experiments/fused_recon_probe_torch.py
- L1 `ops/predictors.py::lossless_recur` (csrc/lossless_recur.cu), the
  lossless predictor recurrence
- E1 `ops/kernels.py::idct_exact_batch` (csrc/idct_exact.cu), the exact
  tier's int32 IDCT: every exact decode, and each stripe of the mesh
They build with nvcc at first launch (`_build.py`); `LAUNCHES` counts the
launches of each.
"""

from ._build import LAUNCHES, reset_launches
from .decoder import Decoder
from .host.decoder import MAX_COMPONENTS, ImageInfo, PixelFormat
from .host.errors import (FormatError, InternalError, IoError, JpegError,
                          UnsupportedError, UnsupportedFeature)
from .host.ops.color import ColorTransform
from .host.parser import CodingProcess, Predictor
from .models.service import BatchDecodeService, decode_many
from .models.stream import DeviceStreamDecoder, StagedBits, stage_host_bits
from .utils.timing import StageTimer

__all__ = [
    "Decoder",
    "ImageInfo",
    "PixelFormat",
    "ColorTransform",
    "CodingProcess",
    "Predictor",
    "JpegError",
    "FormatError",
    "UnsupportedError",
    "UnsupportedFeature",
    "IoError",
    "InternalError",
    "MAX_COMPONENTS",
    "BatchDecodeService",
    "decode_many",
    "StageTimer",
    "DeviceStreamDecoder",
    "StagedBits",
    "stage_host_bits",
    "LAUNCHES",
    "reset_launches",
]

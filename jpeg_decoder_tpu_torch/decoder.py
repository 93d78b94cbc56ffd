"""The port's public decoder: `jpeg_decoder_tpu/decoder.py`'s `Decoder` with
its device backend on PyTorch.

`Decoder` is the host copy's `host.decoder.Decoder` (the marker state
machine, the entropy stage, `scale`, `read_info`, `info`, the metadata
getters, `set_max_decoding_buffer_size` and the typed errors, unchanged)
with the reconstruction moved to a device where the backend says so,
through the host copy's two method hooks:
- DCT images (`_reconstruct_image`, the reference's `_compute_image`,
  `decoder.py:683-703`): one H2D copy of the components' int16
  coefficient stores, then `ops.pipeline.reconstruct` on the device:
  kernel K2 (dequantize + fp32 IDCT, one launch for all components) at
  precision "fast", kernel E1 (the exact int32 IDCT, one launch too) at
  "exact"; then upsampling and color (kernel T1, one launch), and one copy
  back. As the reference's `_compiled_pipeline` (`ops/pipeline.py:
  134-144`) compiles it once per geometry, the reconstruction is one CUDA
  graph per `models.graphs.recon_key` (the geometry, its precision, one
  image, the layout) in the process's cache of the device
  (`models.graphs.device_graphs`), which the process's `Decoder`s share:
  the stores and tables land in the graph's arena in one H2D copy and the
  graph replays, from the key's second call (its first dispatches
  eagerly: a `transfer.put` of the stores, pinned and non-blocking on a
  card, and the kernels' wrappers). The bytes are the reference's layouts
  (L8, RGB24, CMYK32).
- Lossless (SOF3) components (`_reconstruct_lossless_plane`, the
  reference's `_reconstruct_lossless_device`, `decoder.py:573-597`), one
  component at a time by the reference's rule: Ra with a point transform
  on the host oracle; Ra, the `restart_all` quirk and what
  `device_supported` names through the closed forms (the Rc chain runs
  kernel L1); everything else through the wavefront, kernel L1. L8 at
  precision 8, else native-endian L16.

Backends: "numpy" (the host copy as it is), "torch" (on `device`) and
"auto", the reference's size rule (`decoder.py:600-613`): the host at or
below 128 x 128 output pixels, else torch on `device`. As in the
reference, "auto" reconstructs lossless frames on the host. The default is
"torch" on "cuda" (the reference defaults to "numpy"): the port runs on
the card unless the caller asks for the CPU. A CUDA device where there is
no card raises at construction; nothing falls back to the CPU.

`timer` (a `utils.timing.StageTimer`) records the device backend's
"h2d_submit", "device_dispatch" (enqueueing the device work) and "d2h"
(the copy back, which waits for the device).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .host import decoder as _host
from .host.ops.predictors import device_supported
from .host.parser import Predictor
from .models import graphs
from .ops.pipeline import reconstruct
from .ops.predictors import (reconstruct_lossless_device,
                             reconstruct_lossless_wavefront)
from .params import device_params
from .transfer import checked_device, put
from .utils.timing import timed_stage

BACKENDS = ("numpy", "torch", "auto")

def reconstruct_tensor(geometry, stores, qts, device: torch.device,
                       timer=None) -> torch.Tensor:
    """One image on `device`: int16 [n_c, 64] coefficient stores and uint16
    natural-order tables per component -> the reconstructed image, a
    tensor on `device`. The stores and tables land in their
    `graphs.recon_key`'s graph of the process's cache of the device
    (`graphs.device_graphs`, which the process's `Decoder`s share), in
    one H2D submission ("h2d_submit"), and the graph replays
    ("device_dispatch"), from the key's second call; at its first, one
    `put` of the stores and `ops.pipeline.reconstruct`, eagerly."""
    stores = [np.asarray(s, np.int16).reshape(1, -1, 64) for s in stores]
    with timed_stage(timer, "h2d_submit"):
        fill = graphs.recon_fill(graphs.device_graphs(device), geometry,
                                 stores, [tuple(qts)])
        if fill is None:
            dev_stores = put(stores, device)
    with timed_stage(timer, "device_dispatch"):
        if fill is not None:
            return fill.run()[0]
        return reconstruct(geometry, dev_stores, [tuple(qts)],
                           device_params(device))[0]


def reconstruct_on_device(geometry, stores, qts, device: torch.device,
                          timer=None) -> np.ndarray:
    """One image on `device` (`reconstruct_tensor`) as a numpy array ([H, W]
    or [H, W, C] uint8, [H, W * C] for the NONE transform), as
    `host.ops.pipeline.reconstruct_image` gives it; the copy back is the
    "d2h" stage."""
    out = reconstruct_tensor(geometry, stores, qts, device, timer)
    with timed_stage(timer, "d2h"):
        return out.cpu().numpy()


class Decoder(_host.Decoder):
    """JPEG decoder over an in-memory buffer, file object or path, with the
    reconstruction on `device` (module docstring)."""

    def __init__(self, source, backend: str = "torch",
                 precision: str = "exact",
                 max_input_bytes: Optional[int] = None,
                 streaming: bool = False, *, device="cuda", timer=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of "
                             f"{BACKENDS}")
        dev = torch.device(device) if backend == "numpy" \
            else checked_device(device)
        super().__init__(source, "numpy", precision, max_input_bytes,
                         streaming)
        self._backend = backend
        self.device = dev
        self._timer = timer

    def _select_backend(self, frame) -> str:
        """The reference's size rule (`decoder.py:600-613`, threshold
        128 * 128, the reference crate's worker selection): small images
        skip the device dispatch."""
        pixels = frame.output_size.width * frame.output_size.height
        return "numpy" if pixels <= 128 * 128 else "torch"

    def _reconstruct_image(self, geometry, stores, qts) -> np.ndarray:
        backend = self._backend
        if backend == "auto":
            backend = self._select_backend(self.frame)
        if backend == "numpy":
            return super()._reconstruct_image(geometry, stores, qts)
        return reconstruct_on_device(geometry, stores, qts, self.device,
                                     self._timer)

    def _reconstruct_lossless_plane(self, diffs, predictor, pt, precision,
                                    restart_all):
        if self._backend != "torch" or (predictor == Predictor.RA
                                        and pt != 0):
            # The host backends; and Ra with a point transform, which has
            # no device form (the reference hands it to the host oracle).
            return super()._reconstruct_lossless_plane(
                diffs, predictor, pt, precision, restart_all)
        with timed_stage(self._timer, "h2d_submit"):
            (d,) = put([(np.asarray(diffs) & 0xFFFF).astype(np.int32)],
                       self.device)
        with timed_stage(self._timer, "device_dispatch"):
            if predictor == Predictor.RA or restart_all \
                    or device_supported(predictor, pt):
                out = reconstruct_lossless_device(d, predictor, pt,
                                                  precision, restart_all)
            else:
                out = reconstruct_lossless_wavefront(d, predictor, pt,
                                                     precision)
        with timed_stage(self._timer, "d2h"):
            return out.cpu().numpy()

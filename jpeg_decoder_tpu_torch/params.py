"""Constants of the decode, carried from the JAX package to device tensors.

The port's counterpart of carrying weights across: the reference computes
every table once in numpy (Huffman maxcode/delta/values per scan, the MCU
table-pair pattern, quantization tables, the IDCT bases), and this module
only moves those arrays to the device. Nothing is recomputed, so both
packages decode with identical constants.

Sources in the JAX package:
- `entropy/device_scan.py::prescan_baseline` -> `AnchoredScan.tab_maxcode`,
  `tab_delta`, `tab_values` (4 values packed per int32) and `comp_to_upair`;
  `ScanPlan.pattern`; `entropy/scan_python.py::UNZIGZAG`;
- `ops/idct.py::_IDCT_M64_T` (8x8) and `scaled_idct_basis` (4, 2, 1), the
  latter zero-padded to [64, 64] as `ops/pallas_kernels.py::_basis_padded`
  does for the TPU kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jpeg_decoder_tpu.entropy.scan_python import UNZIGZAG
from jpeg_decoder_tpu.ops.idct import _IDCT_M64_T, scaled_idct_basis

MAX_PATTERN = 16    # K1's shared pattern table; an MCU holds at most 10 blocks


@dataclasses.dataclass(frozen=True)
class ScanTables:
    """K1's constant inputs for one scan, on one device."""
    maxcode: torch.Tensor   # int32 [n_tab, 16]
    delta: torch.Tensor     # int32 [n_tab, 16]
    values: torch.Tensor    # int32 [n_tab, 64], 4 symbol bytes per word (LE)
    pattern: torch.Tensor   # int32 [plen]: MCU slot -> unique table pair
    unzig: torch.Tensor     # int32 [64]: zigzag index -> natural index

    @property
    def n_tab(self) -> int:
        return self.maxcode.shape[0]


def scan_tables(scan, device) -> ScanTables:
    """`scan` is a reference `AnchoredScan` (device_scan.prescan_baseline)."""
    pattern = [scan.comp_to_upair[c] for c in (scan.plan.pattern or [0])]
    if len(pattern) > MAX_PATTERN:
        raise ValueError(f"MCU pattern of {len(pattern)} blocks exceeds "
                         f"{MAX_PATTERN}")

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return ScanTables(
        maxcode=put(scan.tab_maxcode),
        delta=put(scan.tab_delta),
        values=put(np.asarray(scan.tab_values, np.uint32).view(np.int32)),
        pattern=put(np.asarray(pattern)),
        unzig=put(np.asarray(UNZIGZAG)))


def quant_table(qt, device, dtype=np.float32) -> torch.Tensor:
    """uint16[64] natural-order quantization table -> [64] of `dtype`:
    float32 as the fast tier multiplies it (K2), int32 as the exact tier
    does (ops/idct.py dequantize_and_idct_blocks)."""
    q = np.asarray(qt).astype(dtype).reshape(64)
    return torch.from_numpy(q).to(device)


def idct_basis(scale: int, device) -> torch.Tensor:
    """float32 [64 coef, 64 px] basis; for scale < 8 only the first
    scale * scale pixel columns are nonzero."""
    if scale == 8:
        m = _IDCT_M64_T
    else:
        m = np.zeros((64, 64), np.float32)
        m[:, :scale * scale] = scaled_idct_basis(scale)
    return torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(device)


class DeviceParams:
    """Device copies of the constants, cached by content: images from one
    encoder share their tables, so each ships to the device once."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._cache: dict = {}

    def _get(self, key, make):
        val = self._cache.get(key)
        if val is None:
            if len(self._cache) > 256:
                self._cache.clear()
            val = self._cache[key] = make()
        return val

    def tables(self, scan) -> ScanTables:
        key = ("tables", scan.tab_maxcode.tobytes(), scan.tab_delta.tobytes(),
               scan.tab_values.tobytes(), tuple(scan.comp_to_upair),
               tuple(scan.plan.pattern))
        return self._get(key, lambda: scan_tables(scan, self.device))

    def qt(self, qt) -> torch.Tensor:
        return self._get(("qt", np.asarray(qt).tobytes()),
                         lambda: quant_table(qt, self.device))

    def qt_exact(self, qt) -> torch.Tensor:
        return self._get(("qt_exact", np.asarray(qt).tobytes()),
                         lambda: quant_table(qt, self.device, np.int32))

    def basis(self, scale: int) -> torch.Tensor:
        return self._get(("basis", scale),
                         lambda: idct_basis(scale, self.device))

"""Constants of the decode, moved to device tensors.

The port's counterpart of carrying weights across: the host stage computes
every table once in numpy (Huffman maxcode/delta/values per scan, the MCU
table-pair pattern, quantization tables, the IDCT bases), and this module
moves those arrays to the device, with what the hand-written kernels need
beside them, derived here in numpy:
- K1's lookahead tables (`lookahead_tables`): per table row, the code
  length, symbol, bits used and zigzag advance of every 11-bit window
  prefix that holds a whole code; and its walk tables (`walk_tables`):
  the bits and advance of the one or two symbols at the head of the
  prefix;
- K2's bases with the quantization table folded in (`folded_basis`):
  diag(q) @ basis in fp32, per (table, scale).

Sources in the port's host copy (`jpeg_decoder_tpu_torch/host/`):
- `entropy/prescan.py::prescan_baseline` -> `AnchoredScan.tab_maxcode`,
  `tab_delta`, `tab_values` (4 values packed per int32) and `comp_to_upair`;
  `ScanPlan.pattern`; `entropy/scan_python.py::UNZIGZAG`;
- `ops/idct.py::_IDCT_M64_T` (8x8) and `scaled_idct_basis` (4, 2, 1), the
  latter zero-padded to [64, 64] as the JAX package's
  `ops/pallas_kernels.py::_basis_padded` does for the TPU kernel.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from .host.entropy.scan_python import UNZIGZAG
from .host.ops.idct import _IDCT_M64_T, scaled_idct_basis

MAX_PATTERN = 16    # K1's shared pattern table; an MCU holds at most 10 blocks
LUT_BITS = 11       # K1's lookahead: window bits resolved by one table load
LUT_SIZE = 1 << LUT_BITS


@dataclasses.dataclass(frozen=True)
class ScanTables:
    """K1's constant inputs for one scan, on one device."""
    maxcode: torch.Tensor   # int32 [n_tab, 16]
    delta: torch.Tensor     # int32 [n_tab, 16]
    values: torch.Tensor    # int32 [n_tab, 64], 4 symbol bytes per word (LE)
    lut: torch.Tensor       # int32 [n_tab, LUT_SIZE]: lookahead_tables
    walk: torch.Tensor      # int32 [n_tab, LUT_SIZE]: walk_tables
    pattern: torch.Tensor   # int32 [plen]: MCU slot -> unique table pair
    unzig: torch.Tensor     # int32 [64]: zigzag index -> natural index

    @property
    def n_tab(self) -> int:
        return self.maxcode.shape[0]


def unpack_values(tab_values) -> np.ndarray:
    """uint32 [n_tab, 64] (4 symbol bytes per word, little-endian) -> uint8
    [n_tab, 256]."""
    w = np.asarray(tab_values, np.uint32)
    return ((w[:, :, None] >> (8 * np.arange(4, dtype=np.uint32)))
            & 0xFF).astype(np.uint8).reshape(w.shape[0], 256)


def chain_decode(win16, maxcode, delta, values):
    """The F.16 maxcode chain, as K1 and its plain version run it, for one
    table row over an array of 16-bit windows: (code length, symbol).
    Codes that match no length take length 16; the symbol index is clamped
    into [0, 255]."""
    win16 = np.asarray(win16, np.int64)
    maxcode = np.asarray(maxcode, np.int64)
    length = np.ones(win16.shape, np.int64)
    run_fail = np.ones(win16.shape, bool)
    for L in range(1, 17):
        run_fail &= (win16 >> (16 - L)) > maxcode[L - 1]
        length += run_fail
    length = np.minimum(length, 16)
    code = win16 >> (16 - length)
    vidx = np.clip(code + np.asarray(delta, np.int64)[length - 1], 0, 255)
    return length, np.asarray(values)[vidx].astype(np.int64)


def lookahead_tables(tab_maxcode, tab_delta, tab_values) -> np.ndarray:
    """K1's lookahead table, int32 [n_tab, LUT_SIZE]. For each table row
    (even rows DC, odd rows AC) and each LUT_BITS-bit window prefix x whose
    maxcode chain ends at a length L <= LUT_BITS (then the code and its
    symbol depend on x alone), the entry is
        symbol | L << 8 | used << 13 | dk << 22
    with `used` = L + the symbol's magnitude bits (the symbol itself in a
    DC row, its low 4 bits in an AC row) and `dk` its advance of the
    zigzag position: 1 for DC, r + 1 for an AC coefficient, 16 for ZRL, 64
    for EOB. The entry is 0 where the code is longer than LUT_BITS (the
    kernel walks the chain)."""
    values = unpack_values(tab_values)
    prefix = np.arange(LUT_SIZE, dtype=np.int64)
    out = np.zeros((len(values), LUT_SIZE), np.int64)
    for row, (mc, dl, vals) in enumerate(zip(tab_maxcode, tab_delta, values)):
        # The lowest window with the prefix: the chain reads its first L bits
        # for L <= LUT_BITS, so a short result holds for the whole prefix.
        length, symbol = chain_decode(prefix << (16 - LUT_BITS), mc, dl, vals)
        mag, dk = _steps_of(symbol, row % 2 == 0)
        entry = symbol | (length << 8) | ((length + mag) << 13) | (dk << 22)
        out[row] = np.where(length <= LUT_BITS, entry, 0)
    return out.astype(np.int32)


WALK_DOUBLE = 1 << 27


def walk_tables(tab_maxcode, tab_delta, tab_values) -> np.ndarray:
    """K1's walk table, int32 [n_tab, LUT_SIZE]: what the walk over a chunk
    needs of the one or two symbols at the head of each LUT_BITS-bit window
    prefix x. For a first code of length L1 <= LUT_BITS (else 0: the kernel
    walks the chain):
        used1 | dk1 << 9 | used2 << 16 | dk2 << 20 | double << 27
    with used1 and dk1 the first symbol's bits (with its magnitude) and
    zigzag advance, as in `lookahead_tables`. `double` is set when the
    first symbol does not end a block by itself (not EOB), its bits lie in
    x, and so does the whole of a second symbol after them, decoded with
    the pair's AC row (the row itself, or the next one after a DC row);
    used2 and dk2 are then the two symbols' bits and advances together.
    The kernel takes both only when the first leaves the block open
    (k + dk1 < 64) and the chunk's step budget has room."""
    values = unpack_values(tab_values)
    prefix = np.arange(LUT_SIZE, dtype=np.int64)
    out = np.zeros((len(values), LUT_SIZE), np.int64)
    for row in range(len(values)):
        dc = row % 2 == 0
        ac = row + 1 if dc else row
        length, symbol = chain_decode(prefix << (16 - LUT_BITS),
                                      tab_maxcode[row], tab_delta[row],
                                      values[row])
        mag, dk = _steps_of(symbol, dc)
        used1 = length + mag
        # The second symbol: the bits after the first, zero-padded; its
        # chain result holds when it ends within the bits that are there.
        avail = LUT_BITS - used1
        rest = (prefix << np.clip(used1, 0, LUT_BITS)) & (LUT_SIZE - 1)
        length2, symbol2 = chain_decode(rest << (16 - LUT_BITS),
                                        tab_maxcode[ac], tab_delta[ac],
                                        values[ac])
        mag2, dk2 = _steps_of(symbol2, False)
        double = ((length <= LUT_BITS) & (dk < 64) & (avail > 0)
                  & (length2 + mag2 <= avail))
        entry = (used1 | (dk << 9)
                 | np.where(double, ((used1 + length2 + mag2) << 16)
                            | ((dk + dk2) << 20) | WALK_DOUBLE, 0))
        out[row] = np.where(length <= LUT_BITS, entry, 0)
    return out.astype(np.int32)


def _steps_of(symbol, is_dc: bool):
    """(magnitude bits, zigzag advance dk) of decoded symbols, as K1 counts
    them: dk is 1 for DC, r + 1 for an AC coefficient, 16 for ZRL and 64
    for EOB."""
    symbol = np.asarray(symbol, np.int64)
    if is_dc:
        return symbol, np.ones_like(symbol)
    r, s = symbol >> 4, symbol & 15
    return s, np.where(s != 0, r + 1, np.where(r == 15, 16, 64))


def scan_table_arrays(scan) -> ScanTables:
    """K1's constant inputs for one scan as int32 numpy arrays, in the
    fields of `ScanTables`. `scan` is an `AnchoredScan` of the host prescan
    (`host/entropy/prescan.py::prescan_baseline`) or of the transcoder."""
    pattern = [scan.comp_to_upair[c] for c in (scan.plan.pattern or [0])]
    if len(pattern) > MAX_PATTERN:
        raise ValueError(f"MCU pattern of {len(pattern)} blocks exceeds "
                         f"{MAX_PATTERN}")

    def i32(a):
        return np.ascontiguousarray(a, np.int32)

    return ScanTables(
        maxcode=i32(scan.tab_maxcode),
        delta=i32(scan.tab_delta),
        values=i32(np.asarray(scan.tab_values, np.uint32).view(np.int32)),
        lut=lookahead_tables(scan.tab_maxcode, scan.tab_delta,
                             scan.tab_values),
        walk=walk_tables(scan.tab_maxcode, scan.tab_delta, scan.tab_values),
        pattern=i32(pattern),
        unzig=i32(UNZIGZAG))


def scan_tables(scan, device) -> ScanTables:
    """`scan_table_arrays` on `device`."""
    arrays = scan_table_arrays(scan)
    return ScanTables(**{f.name: torch.from_numpy(getattr(arrays, f.name))
                         .to(device) for f in dataclasses.fields(ScanTables)})


def quant_table(qt, device, dtype=np.float32) -> torch.Tensor:
    """uint16[64] natural-order quantization table -> [64] of `dtype`:
    float32 as the fast tier multiplies it (K2), int32 as the exact tier
    does (kernel E1, ops/kernels.py idct_exact_batch)."""
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


def folded_basis(qt, scale: int, device) -> torch.Tensor:
    """K2's basis for one quantization table: float32 [64 coef, 64 px],
    row c of `idct_basis(scale)` times q[c], each product rounded to fp32
    once (the same values as `q[:, None] * basis` in fp32 on the card)."""
    q = np.asarray(qt).astype(np.float32).reshape(64, 1)
    m = idct_basis(scale, "cpu").numpy()
    return torch.from_numpy(np.ascontiguousarray(q * m, np.float32)).to(device)


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

    def folded(self, qt, scale: int) -> torch.Tensor:
        return self._get(("folded", np.asarray(qt).tobytes(), scale),
                         lambda: folded_basis(qt, scale, self.device))


_params: dict = {}
_params_lock = threading.Lock()


def device_params(device) -> DeviceParams:
    """The process's `DeviceParams` for one device (tables and bases shared
    by every image decoded there, and by its graph cache,
    `models.graphs.device_graphs`)."""
    from .transfer import checked_device

    device = checked_device(device)
    with _params_lock:
        params = _params.get(device)
        if params is None:
            params = _params[device] = DeviceParams(device)
        return params

#!/usr/bin/env python
"""Fused stores -> pixels probe on a CUDA card: kernel K4 of the PyTorch port.

    python tools/experiments/fused_recon_probe_torch.py [--image PATH]
                                                        [--iters N]

Port of tools/experiments/fused_recon_probe.py. One kernel
(`jpeg_decoder_tpu_torch.ops.kernels.fused_recon`, csrc/fused_recon.cu)
takes 4:4:4 YCbCr coefficient stores, int16 [bh, bw, 64] per component,
to planar RGB uint8 [3, bh * 8, W]: dequant + IDCT, block -> raster,
color, with no uint8 plane written in between.

Three inputs:
- `--image`, a 4:4:4 YCbCr JPEG (default the fixture
  tests/fixtures/torch_port/small_444.jpg), decoded to stores by the host
  oracle (the port's copy, `jpeg_decoder_tpu_torch.host`, numpy backend);
- seeded stores at the kernel's edges: 131 x 11 blocks (three blocks past
  its 128-block tiles), width 1043 (cut mid-block, not a multiple of 16),
  and coefficients of magnitude 2048-4095 in about one block in 40 (the
  split product's lo*hi term, which a warp skips where it has none);
- seeded random stores at the 3.44 Mpix 4:4:4 shape of 256 x 210 blocks
  (2048 x 1680), with the image's quantization tables.

For each it prints one JSON line with the CUDA-event ms of
- floor: the three stores summed in int32 and cast to uint8 (reading the
  stores and writing one plane: the probe's own floor);
- K4: `fused_recon`;
- X: the unfused path, K2 (`dequant_idct`) per component,
  `blocks_to_plane` and `ycbcr_to_rgb`;
- plain: K4's plain version (cuBLAS fp32 matmul, then the same tail);
and "K4 vs X max |diff|", which must be 0 (K4's IDCT is K2's split-TF32
tensor-core product on the same folded bases), and K4 vs plain, 3 at most
(the plain version's cuBLAS fp32 product rounds in other places: 1 in the
IDCT, times up to 1.772 through color). It exits nonzero if either bound
is missed.

The TPU probe's stages P0 (copy-through) and P1 (IDCT without the
shuffle) measured whether Mosaic could afford the block -> raster shuffle
in VMEM at all. On the GPU the shuffle is a shared-memory transpose, so
they are not ported. Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_IMAGE = ROOT / "tests" / "fixtures" / "torch_port" / "small_444.jpg"
LARGE_BLOCKS = (210, 256)      # (bh, bw): 2048 x 1680, 3.44 Mpix
EDGE_BLOCKS = (11, 131)        # (bh, bw): 3 blocks past K4's 128-block tile
EDGE_WIDTH = 131 * 8 - 5       # 1043: cut mid-block, not a multiple of 16
X_TOL = 0                      # K4 vs the K2 path: the same IDCT arithmetic
PLAIN_TOL = 3                  # vs plain: 1 in the IDCT, x1.772 in color


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms per call over `iters` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def image_stores(data: bytes):
    """Host-oracle stores [bh, bw, 64] x 3, uint16 qts and the width of a
    4:4:4 YCbCr JPEG; raises ValueError for anything else."""
    from jpeg_decoder_tpu_torch.host.decoder import Decoder
    from jpeg_decoder_tpu_torch.host.ops.color import ColorTransform

    d = Decoder(data, backend="numpy")
    d._decode_entropy_only()
    comps = d.frame.components
    if len(comps) != 3 or d._determine_color_transform() \
            != ColorTransform.YCBCR:
        raise ValueError("K4 takes 3-component YCbCr JPEGs")
    dims = {(c.block_size.height, c.block_size.width, c.dct_scale)
            for c in comps}
    if len(dims) != 1 or next(iter(dims))[2] != 8:
        raise ValueError(f"K4 takes 4:4:4 at full scale, got {dims}")
    bh, bw, _ = next(iter(dims))
    stores = [d._pending_render[i][0].reshape(bh, bw, 64) for i in range(3)]
    qts = [d._pending_render[i][1] for i in range(3)]
    return stores, qts, d.frame.output_size.width


def run_case(name: str, stores, qts, width: int, iters: int) -> dict:
    """Time and compare K4, X, plain and the floor on one set of stores."""
    from jpeg_decoder_tpu_torch.ops.kernels import (dequant_idct,
                                                    fused_recon,
                                                    fused_recon_plain)

    args = case_args(stores, qts, width)
    y, cb, cr = args[:3]

    k4 = fused_recon(*args).to(torch.int32)
    x = fused_recon_plain(*args, k2=dequant_idct).to(torch.int32)
    plain = fused_recon_plain(*args).to(torch.int32)
    torch.cuda.synchronize()
    return {
        "case": name, "blocks": list(y.shape[:2]), "width": width,
        "out_shape": list(k4.shape),
        "floor_ms": cuda_ms(lambda: (y.to(torch.int32) + cb + cr)
                            .to(torch.uint8), iters),
        "k4_ms": cuda_ms(lambda: fused_recon(*args), iters),
        "x_ms": cuda_ms(lambda: fused_recon_plain(*args, k2=dequant_idct),
                        iters),
        "plain_ms": cuda_ms(lambda: fused_recon_plain(*args), iters),
        "k4_vs_x_max_abs_diff": int((k4 - x).abs().max()),
        "k4_vs_plain_max_abs_diff": int((k4 - plain).abs().max()),
        "device": torch.cuda.get_device_name(0)}


def seeded_stores(seed: int = 0, blocks=LARGE_BLOCKS,
                  big: bool = False) -> list:
    """Seeded int16 stores [bh, bw, 64] x 3, by default at the 3.44 Mpix
    4:4:4 shape; `big` sets the first 8 coefficients of about one block in
    40 to magnitudes 2048-4095."""
    rng = np.random.default_rng(seed)
    stores = []
    for _ in range(3):
        s = rng.integers(-256, 256, (*blocks, 64))
        if big:
            hot = rng.random(blocks) < 1 / 40
            n = int(hot.sum())
            s[hot, :8] = rng.choice([-1, 1], (n, 8)) \
                * rng.integers(2048, 4096, (n, 8))
        stores.append(s.astype(np.int16))
    return stores


def case_args(stores, qts, width: int) -> tuple:
    """`fused_recon`'s arguments on the card for one set of stores."""
    from jpeg_decoder_tpu_torch.params import idct_basis, quant_table

    dev = torch.device("cuda")
    y, cb, cr = (torch.from_numpy(np.ascontiguousarray(s, np.int16)).to(dev)
                 for s in stores)
    q = torch.stack([quant_table(qt, dev) for qt in qts])
    return (y, cb, cr, q, idct_basis(8, dev), width)


def run(image: Path = DEFAULT_IMAGE, iters: int = 20, seed: int = 0) -> list:
    """The three cases, the 256 x 210 blocks last: the image's stores, then
    seeded stores at the edges and at 256 x 210 blocks, with the image's
    tables."""
    stores, qts, width = image_stores(image.read_bytes())
    bw = LARGE_BLOCKS[1]
    return [run_case(image.name, stores, qts, width, iters),
            run_case(f"seeded_edge_{EDGE_BLOCKS[1]}x{EDGE_BLOCKS[0]}_blocks",
                     seeded_stores(seed + 1, EDGE_BLOCKS, big=True), qts,
                     EDGE_WIDTH, iters),
            run_case(f"seeded_{bw}x{LARGE_BLOCKS[0]}_blocks",
                     seeded_stores(seed), qts, bw * 8, iters)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image", type=Path, default=DEFAULT_IMAGE)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    bad = 0
    for res in run(args.image, args.iters):
        print(json.dumps(res))
        print(f"{res['case']}: K4 vs X max |diff| "
              f"{res['k4_vs_x_max_abs_diff']}")
        bad += res["k4_vs_x_max_abs_diff"] > X_TOL \
            or res["k4_vs_plain_max_abs_diff"] > PLAIN_TOL
    return 1 if bad else 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())

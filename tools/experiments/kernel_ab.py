#!/usr/bin/env python
"""Kernel device times of one checkout of the port, for A/B runs on a card.

    python tools/experiments/kernel_ab.py TREE

TREE is the root of a checkout of this repository (this one: `.`; another
commit: unpack it with `git archive COMMIT | tar -x -C DIR` into a directory
`.gitignore` lists). The script imports the port from TREE, stages the
3.44 Mpix fixture (large_420) and the 512x512 one (tower_420) from this
checkout's fixtures, and prints one JSON line with, per fixture, the device
time per call of K1 (`decode_chunks`) by kernel name and of everything the
K1 wrapper enqueues (a zero fill included, where a version has one), and
for large_420 the device time of K2 over the image's three components as
the main path calls it, all from torch.profiler over 50 warm calls
(`tools/torch_port_profile.py::kernel_device_us` of this checkout); then
K3 (`fused_tail`) on seeded planes of large_420's shapes (1680 x 2048
luma, two 840 x 1024 chroma planes at h2v2) and L1 (`lossless_recur`) on
a seeded [1, 2048, 2048] plane at predictor 6 and on [3, 2048, 2048] in
one call (50, 10 and 5 calls). Run
parent, change, change, parent in one call to compare two versions on one
card. Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not torch.cuda.is_available():
        print("usage: kernel_ab.py TREE (needs a CUDA device)", file=sys.stderr)
        return 1
    tree = Path(argv[0]).resolve()
    sys.path.insert(0, str(HERE))
    from tools.torch_port_profile import kernel_device_us

    sys.path.insert(0, str(tree))
    for name in [m for m in sys.modules if m.startswith("jpeg_decoder_tpu")]:
        del sys.modules[name]
    from jpeg_decoder_tpu_torch import stage_host_bits
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import (decode_chunks,
                                                             unpack_delta)
    from jpeg_decoder_tpu_torch.params import DeviceParams

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    params = DeviceParams(dev)
    out = {"tree": str(tree), "device": torch.cuda.get_device_name(0)}
    fixtures = HERE / "tests" / "fixtures" / "torch_port"
    for name in ("large_420.jpg", "tower_420.jpg"):
        blob = (fixtures / name).read_bytes()
        staged = stage_host_bits(blob)
        (st,) = staged.scans
        dm = torch.from_numpy(st.dm).to(dev)
        ab, _budget, _slot, base = unpack_delta(dm)
        args = (torch.from_numpy(st.words).to(dev), dm, ab, base,
                params.tables(st.scan), st.s_max, st.scan.plan.n_blocks)
        k1 = kernel_device_us(lambda: decode_chunks(*args),
                              "huffman_decode_kernel", iters=50)
        out[name] = {"k1_kernel_us": k1["kernel_us"],
                     "k1_call_device_us": k1["all_device_us"],
                     "k1_call_launches": k1["all_launches"]}
        if name != "large_420.jpg":
            continue
        try:
            from jpeg_decoder_tpu_torch.host.decoder import Decoder
        except ImportError:     # a checkout from before the host copy
            from jpeg_decoder_tpu.decoder import Decoder
        d = Decoder(blob, backend="numpy")
        d._decode_entropy_only()
        stores = [torch.from_numpy(d._pending_render[i][0].reshape(-1, 64))
                  .to(dev) for i in range(3)]
        qts = [d._pending_render[i][1] for i in range(3)]
        try:
            from jpeg_decoder_tpu_torch.ops.pipeline import fast_pixels

            def k2_image():
                return fast_pixels(staged.geometry, stores, qts, params)
        except ImportError:     # a checkout with one K2 launch per component
            from jpeg_decoder_tpu_torch.ops.kernels import dequant_idct

            def k2_image():
                return [dequant_idct(s, params.qt(q), params.basis(8), 8)
                        for s, q in zip(stores, qts)]
        k2 = kernel_device_us(k2_image, "dequant_idct_kernel", iters=50)
        out[name].update(k2_kernel_us=k2["kernel_us"],
                         k2_launches=k2["launches"])
    from jpeg_decoder_tpu_torch.ops.kernels import fused_tail
    from jpeg_decoder_tpu_torch.ops.predictors import lossless_recur

    rng = np.random.default_rng(0)
    planes = [torch.from_numpy(rng.integers(0, 256, s).astype(np.uint8))
              .to(dev) for s in ((1680, 2048), (840, 1024), (840, 1024))]
    k3 = kernel_device_us(
        lambda: fused_tail(planes, ("h1v1", "h2v2", "h2v2"), (840, 1024),
                           "ycbcr", 1680, 2048),
        "fused_tail_kernel", iters=50)
    out["k3_large_420_kernel_us"] = k3["kernel_us"]
    for c, iters in ((1, 10), (3, 5)):
        d = torch.from_numpy(rng.integers(0, 65536, (c, 2048, 2048))
                             .astype(np.int32)).to(dev)
        l1 = kernel_device_us(lambda: lossless_recur(d, 6, 0, 1 << 15),
                              "lossless_recur_kernel", iters=iters)
        out[f"l1_{c}x2048x2048_p6_kernel_us"] = l1["kernel_us"]
        out[f"l1_{c}x2048x2048_p6_launches"] = l1["launches"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

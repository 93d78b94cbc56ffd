#!/usr/bin/env python
"""Kernel device times of one checkout of the port, for A/B runs on a card.

    python tools/experiments/kernel_ab.py TREE [--only p1d1]

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
luma, two 840 x 1024 chroma planes at h2v2), K4 (`fused_recon`) on the
seeded 3 x [210, 256, 64] stores of tools/experiments/
fused_recon_probe_torch.py with large_420's tables, beside the device time
of the unfused K2 path it replaces (`fused_recon_plain(k2=dequant_idct)`,
every kernel it launches), and L1 (`lossless_recur`) on a seeded
[1, 2048, 2048] plane at predictor 6 and on [3, 2048, 2048] in one call
(50, 50, 20, 10 and 5 calls), and T1 (`interleaved_tail`) on seeded
block pixels of large_420's geometry (interleaved and planar) and of 16
tower_420 images in one call, 50 calls each, with the median, least and
largest time of one launch, and U1 (`unpack_delta`) on large_420's wire
(6,144 entries), the merged wires of 16 tower_420 and 16 large_420
images and wires of 65,536 and 1,048,576 entries, 100 calls each, with
the same statistics and the device time of all a call enqueues. Beside
the times, SHA-256 digests of what the checkout computes, to show two
versions bit-equal: T1's outputs on those pixels, U1's on those wires,
K2's outputs
(`dequant_idct_multi`, three components in one call) on seeded
coefficients at scales 8, 4, 2 and 1 and magnitudes up to 300, 1024, 4096
and 32767, K4's output on the stores above, and the fast interleaved
decode of every fixture. Then P1 (`prefix_stores`) on large_420's prefix
wire (`stage_host`, one image: 80,640 blocks, 44,032 residual entries) and
on the merged wire of a prefix group of 16 tower_420 (`_group_wires`:
98,304 blocks), and D1 (`dc_totals`) on seeded int16 nat of one image of
large_420's stripe plans at 4 and 8 stripes (20,736 and 10,752 blocks),
100 warm calls each: per kernel name (each of P1's passes apart where a
version has two) the mean, median, least and largest device µs of a
launch and the launches a call, the device time of everything the wrapper
enqueues a call, the span of a call on the card (CUDA events, the gaps
between launches included), and SHA-256 digests of P1's stores and D1's totals.
`--only p1d1` measures P1 and D1 alone. Run parent, change, change, parent
in one call to compare two versions on one card. Needs a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only = argv[1:] == ["--only", "p1d1"]
    if len(argv) not in (1, 3) or (len(argv) == 3 and not only) \
            or not torch.cuda.is_available():
        print("usage: kernel_ab.py TREE [--only p1d1] (needs a CUDA device)",
              file=sys.stderr)
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
    if only:
        out.update(p1_d1_times(dev, fixtures, stage_host_bits))
        print(json.dumps(out))
        return 0
    for name in ("large_420.jpg", "tower_420.jpg"):
        blob = (fixtures / name).read_bytes()
        staged = stage_host_bits(blob)
        (st,) = staged.scans
        dm = torch.from_numpy(st.dm).to(dev)
        unpacked = unpack_delta(dm)     # (ab, ..., base) in every version
        ab, base = unpacked[0], unpacked[-1]
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
        k4_qts = torch.stack([params.qt(q) for q in qts])
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
    from jpeg_decoder_tpu_torch.ops.kernels import (dequant_idct, fused_recon,
                                                    fused_recon_plain,
                                                    fused_tail)
    from jpeg_decoder_tpu_torch.ops.predictors import lossless_recur

    rng = np.random.default_rng(0)
    planes = [torch.from_numpy(rng.integers(0, 256, s).astype(np.uint8))
              .to(dev) for s in ((1680, 2048), (840, 1024), (840, 1024))]
    k3 = kernel_device_us(
        lambda: fused_tail(planes, ("h1v1", "h2v2", "h2v2"), (840, 1024),
                           "ycbcr", 1680, 2048),
        "fused_tail_kernel", iters=50)
    out["k3_large_420_kernel_us"] = k3["kernel_us"]
    rng4 = np.random.default_rng(0)     # the probe's seeded_stores(0)
    k4_args = (*[torch.from_numpy(rng4.integers(-256, 256, (210, 256, 64))
                                  .astype(np.int16)).to(dev)
                 for _ in range(3)], k4_qts, params.basis(8), 2048)
    k4 = kernel_device_us(lambda: fused_recon(*k4_args), "fused_recon_kernel",
                          iters=50)
    unfused = kernel_device_us(
        lambda: fused_recon_plain(*k4_args, k2=dequant_idct), "", iters=20)
    out["k4_256x210_kernel_us"] = k4["kernel_us"]
    out["k4_256x210_sha256"] = hashlib.sha256(
        fused_recon(*k4_args).cpu().numpy().tobytes()).hexdigest()
    out["k4_256x210_unfused_device_us"] = unfused["all_device_us"]
    out["k4_256x210_unfused_launches"] = unfused["all_launches"]
    for c, iters in ((1, 10), (3, 5)):
        d = torch.from_numpy(rng.integers(0, 65536, (c, 2048, 2048))
                             .astype(np.int32)).to(dev)
        l1 = kernel_device_us(lambda: lossless_recur(d, 6, 0, 1 << 15),
                              "lossless_recur_kernel", iters=iters)
        out[f"l1_{c}x2048x2048_p6_kernel_us"] = l1["kernel_us"]
        out[f"l1_{c}x2048x2048_p6_launches"] = l1["launches"]
    out.update(t1_times(dev, fixtures, stage_host_bits))
    out.update(u1_times(dev, fixtures, stage_host_bits))
    out.update(p1_d1_times(dev, fixtures, stage_host_bits))
    out.update(digests(dev, params, fixtures))
    print(json.dumps(out))
    return 0


def t1_times(dev, fixtures, stage_host_bits) -> dict:
    """T1's device time per launch (mean, median, least, largest over 50
    calls) and the SHA-256 of its outputs, on seeded block pixels of
    large_420's geometry and of 16 tower_420 images."""
    from tools.torch_port_profile import kernel_device_us
    from jpeg_decoder_tpu_torch.ops.kernels import interleaved_tail

    out, digest = {}, hashlib.sha256()
    for name, images, planar in (("large_420", 1, False),
                                 ("large_420", 1, True),
                                 ("tower_420", 16, False)):
        geometry = stage_host_bits(
            (fixtures / f"{name}.jpg").read_bytes()).geometry
        rng = np.random.default_rng(images)
        pixels = [torch.from_numpy(rng.integers(
            0, 256, (images, c.blocks_wide * c.blocks_high, c.dct_scale,
                     c.dct_scale), dtype=np.uint8)).to(dev)
            for c in geometry.components]
        args = (pixels, geometry.components, geometry.transform,
                geometry.out_height, geometry.out_width)
        t1 = kernel_device_us(lambda: interleaved_tail(*args, planar=planar),
                              "interleaved_tail_kernel", iters=50)
        each = sorted(t1["each_us"])
        key = f"t1_{name}_x{images}" + ("_planar" if planar else "")
        out[key] = {"kernel_us": t1["kernel_us"],
                    "median_us": each[len(each) // 2], "min_us": each[0],
                    "max_us": each[-1], "launches": t1["launches"]}
        digest.update(interleaved_tail(*args, planar=planar).cpu().numpy()
                      .tobytes())
    out["t1_sha256"] = digest.hexdigest()
    return out


def u1_times(dev, fixtures, stage_host_bits) -> dict:
    """U1's device time per launch (median, least, largest over 100 calls)
    and the SHA-256 of its outputs on large_420's wire (6,144 entries), the
    merged wires of 16 tower_420 and 16 large_420 images (`merge_scans`,
    as `decode_stream(batch_size=16)` ships them) and wires of 65,536 and
    1,048,576 entries repeating large_420's."""
    from tools.torch_port_profile import kernel_device_us
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import unpack_delta
    from jpeg_decoder_tpu_torch.models.stream import merge_scans

    scans = {name: stage_host_bits((fixtures / f"{name}.jpg").read_bytes())
             .scans[0] for name in ("large_420", "tower_420")}
    large = torch.from_numpy(scans["large_420"].dm)
    wires = {"large_420": large, "65536": large.repeat(11)[:65536],
             "1048576": large.repeat(171)[:1 << 20]}
    for name in ("tower_420", "large_420"):
        (_words, dm), _s_max, _n = merge_scans([scans[name]] * 16)
        wires[f"{name}_x16"] = torch.from_numpy(dm)
    out, digest = {}, hashlib.sha256()
    for label, wire in wires.items():
        wire = wire.to(dev)
        u1 = kernel_device_us(lambda: unpack_delta(wire),
                              "unpack_delta_kernel", iters=100)
        each = sorted(u1["each_us"])
        out[f"u1_{label}"] = {"entries": wire.numel(),
                              "kernel_us": u1["kernel_us"],
                              "median_us": each[len(each) // 2],
                              "min_us": each[0], "max_us": each[-1],
                              "launches": u1["launches"],
                              "call_device_us": u1["all_device_us"],
                              "call_launches": u1["all_launches"]}
        got = unpack_delta(wire)
        for t in (got[0], got[-1]):     # ab, base in every version
            digest.update(t.cpu().numpy().tobytes())
    out["u1_sha256"] = digest.hexdigest()
    return out


def by_kernel(fn, prefix: str, iters: int = 100) -> dict:
    """Device µs of each kernel whose name starts with `prefix` (mean,
    median, least, largest launch; launches a call) and of everything a
    call of `fn` enqueues, from torch.profiler over `iters` calls after
    three warm-up calls; then the span of a call on the card (the gaps
    between its launches included: `card_span_us`), median, least and
    largest."""
    from torch.profiler import ProfilerActivity

    from tools.torch_port_profile import card_span_us

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _attempt in range(3):   # a trace now and then comes back empty
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        on_card = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        names = {}
        for e in on_card:
            # The kernel's own name, past "(anonymous namespace)::".
            found = re.search(r"(\w+)(?:<[^>]*>)?\(", e.name)
            name = found[1] if found else e.name
            if name.startswith(prefix):
                names.setdefault(name, []).append(e.time_range.elapsed_us())
        if names:
            break
    else:
        raise RuntimeError(f"the profiler saw no {prefix!r} kernel")
    out = {}
    for name, each in sorted(names.items()):
        each.sort()
        out[name] = {"mean_us": sum(each) / len(each),
                     "median_us": each[len(each) // 2], "min_us": each[0],
                     "max_us": each[-1],
                     "launches_per_call": round(len(each) / iters)}
    out["call_device_us"] = sum(e.time_range.elapsed_us()
                                for e in on_card) / iters
    out["call_launches"] = round(len(on_card) / iters)
    out.update(card_span_us(fn, iters))
    return out


def p1_d1_times(dev, fixtures, stage_host_bits) -> dict:
    """P1 on large_420's prefix wire and a prefix group of 16 tower_420;
    D1 on seeded nat of large_420's stripe plans at 4 and 8 (module
    docstring); with SHA-256 digests of their outputs."""
    import jpeg_decoder_tpu_torch as jt
    from jpeg_decoder_tpu_torch.entropy.assemble import dc_totals
    from jpeg_decoder_tpu_torch.entropy.prefix import prefix_stores
    from jpeg_decoder_tpu_torch.host.staging import stage_host
    from jpeg_decoder_tpu_torch.parallel.stripe_bits import (
        split_anchored_stripes)

    large = (fixtures / "large_420.jpg").read_bytes()
    st = stage_host(large)
    wires = {"large_420": (st.geometry, [
        torch.from_numpy(a).to(dev)
        for a in (st.dc, st.ac, st.resid_idx, st.resid_vals)])}
    with jt.DeviceStreamDecoder(device=dev, host_threads=1,
                                interchange="prefix") as dec:
        one = dec.stage((fixtures / "tower_420.jpg").read_bytes())
        wires["tower_420_x16"] = (one.geometry,
                                  dec._group_wires("prefix", [one] * 16))
    out, p1_digest, d1_digest = {}, hashlib.sha256(), hashlib.sha256()
    for label, (geometry, wire) in wires.items():
        out[f"p1_{label}"] = {"blocks": wire[0].numel(),
                              "entries": wire[2].numel(),
                              **by_kernel(lambda: prefix_stores(geometry,
                                                                *wire),
                                          "prefix_")}
        for store in prefix_stores(geometry, *wire):
            p1_digest.update(store.cpu().numpy().tobytes())
    scan = stage_host_bits(large).scans[0].scan
    for n in (4, 8):
        plan = split_anchored_stripes(scan, n).plan
        nat = torch.from_numpy(np.random.default_rng(n).integers(
            -32768, 32768, (1, plan.n_blocks, 64), dtype=np.int16)).to(dev)
        out[f"d1_large_420_stripe_at_{n}"] = {
            "blocks": plan.n_blocks,
            **by_kernel(lambda: dc_totals(nat, plan), "dc_totals")}
        d1_digest.update(dc_totals(nat, plan).cpu().numpy().tobytes())
    out["p1_sha256"] = p1_digest.hexdigest()
    out["d1_sha256"] = d1_digest.hexdigest()
    return out


def digests(dev, params, fixtures) -> dict:
    """SHA-256 of K2's outputs on seeded coefficients and of the fast
    decode of every fixture, by the imported checkout."""
    import jpeg_decoder_tpu_torch as jt
    from jpeg_decoder_tpu_torch.ops.kernels import dequant_idct_multi

    rng = np.random.default_rng(1)
    k2 = hashlib.sha256()
    for scale in (8, 4, 2, 1):
        for lim in (300, 1024, 4096, 32767):
            coefs = [torch.from_numpy(rng.integers(-lim, lim, (n, 64))
                                      .astype(np.int16)).to(dev)
                     for n in (5001, 700, 129)]
            qs = [params.qt(rng.integers(1, 100, 64).astype(np.uint16))
                  for _ in range(3)]
            for o in dequant_idct_multi(coefs, qs, [params.basis(scale)] * 3,
                                        [scale] * 3):
                k2.update(o.cpu().numpy().tobytes())
    images = hashlib.sha256()
    with jt.DeviceStreamDecoder(device=dev, host_threads=2) as dec:
        for path in sorted(fixtures.glob("*.jpg")):
            images.update(dec.decode_stream([path.read_bytes()])[0].cpu()
                          .numpy().tobytes())
    return {"k2_sha256": k2.hexdigest(),
            "fixtures_fast_sha256": images.hexdigest()}


if __name__ == "__main__":
    sys.exit(main())

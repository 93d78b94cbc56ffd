"""Smoke run of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Drives the port's paths (jpeg_decoder_tpu_torch.DeviceStreamDecoder on
"cuda" in the interleaved and planar layouts, and the K4 probe
tools/experiments/fused_recon_probe_torch.py) over the committed fixtures
in tests/fixtures/torch_port/, after building every hand-written kernel
from csrc/ and holding each against its plain PyTorch version on the card:

1. card name and power limit (nvidia-smi), native host library status;
2. kernel build (nvcc), with its time;
3. K1 (Huffman decode) on the card vs its plain version on the card and vs
   the host oracle's coefficient stores, every fixture: bit-equal;
4. K2 (dequant + IDCT) on the card vs its plain version on the card, on
   fixture stores and seeded random coefficients: |diff| <= 1;
5. the slice: decode_stream(all fixtures) -> CUDA tensors, launch counts
   of both kernels > 0, every image within 3 of the host exact decode;
6. CUDA-event times: device-resident ms/image for the 3.4 Mpix and
   512x512 fixtures, each kernel beside its plain version at the main
   path's shapes, and host staging ms/image;
7. K3 (fused upsample + color) vs its plain version on the card, on every
   fixture geometry it takes and on seeded planes (h1v2, YCCK, CMYK 4:4:4,
   CMYK h2v2 on 3 components, width-1 chroma, odd sizes): bit-equal;
8. the planar slice: decode_stream(layout="planar-pallas") and "planar"
   over every fixture, each bit-equal to phase 5's interleaved image
   permuted (gray as is), K3 launched in the planar-pallas run;
9. K4 through its probe: bit-equal to K2 + blocks_to_plane + color and
   within 3 of its plain version on small_444 and on seeded 256 x 210
   block stores, K4 launched in the probe's run;
10. times of the planar tail: device-resident ms/image and launches per
   image (profiler) of planar-pallas beside interleaved, and K3 beside its
   plain version at large_420's planes.

Any failure raises and the script exits nonzero. It needs a CUDA device and
the repository around it; it imports neither JAX nor PIL. The last line is
{"ok": true, "device": {...}}; the line before it is nvidia-smi's card
name and power limit, and before that a JSON line with one entry per kernel.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"
ORDER = ("large_420.jpg", "tower_420.jpg", "small_444.jpg", "small_422.jpg",
         "small_gray.jpg", "small_dri.jpg", "small_cmyk_420.jpg",
         "small_rgb_444.jpg")
K2_TOL = 1      # fp32 sums in another order: at most one rounding step
PIXEL_TOL = 3   # fast-tier contract against the exact integer decode
K4_TOL = 3      # K4 vs its cuBLAS plain version: 1 in the IDCT, x1.772 color
RATE_FIXTURES = ("large_420.jpg", "tower_420.jpg")
# K3 geometries beyond the fixtures': (comp_modes, transform, out_h, out_w,
# chroma_dims).
TAIL_CASES = (
    (("h1v1", "h1v2", "h1v2"), "ycbcr", 90, 130, (45, 130)),
    (("h1v1", "h2v2", "h2v2", "h1v1"), "ycck", 63, 77, (32, 39)),
    (("h1v1", "h1v2", "h1v2", "h1v1"), "ycck", 31, 45, (16, 45)),
    (("h1v1",) * 4, "cmyk", 35, 53, None),
    (("h1v1", "h2v2", "h2v2", "h2v2"), "cmyk", 75, 111, (38, 56)),
    (("h1v1", "h2v2", "h2v2"), "ycbcr", 9, 2, (5, 1)),
    (("h1v1", "h2v1", "h2v1"), "ycbcr", 7, 1, (7, 1)),
    (("h1v1", "h2v2", "h2v2"), "ycbcr", 1001, 1667, (501, 834)),
    (("h1v1", "h2v1", "h2v1"), "ycbcr", 333, 517, (333, 259)),
)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return res.stdout.strip().splitlines()[0]


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


def seeded_planes(case, rng, dev) -> list:
    """Block-padded uint8 planes for one TAIL_CASES entry, on `dev`."""
    modes, _transform, out_h, out_w, chroma = case
    hc, wc = chroma if chroma is not None else (out_h, out_w)
    planes = []
    for m in modes:
        h = out_h if m == "h1v1" else hc
        w = wc if m.startswith("h2") else out_w
        planes.append(torch.from_numpy(rng.integers(
            0, 256, (-(-h // 8) * 8 + 8, -(-w // 8) * 8)).astype(np.uint8))
            .to(dev))
    return planes


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import jpeg_decoder_tpu_torch as jt
    from jpeg_decoder_tpu import Decoder
    from jpeg_decoder_tpu.entropy.native import get_native
    from jpeg_decoder_tpu_torch import _build
    from jpeg_decoder_tpu_torch.entropy.assemble import assemble_nat
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import (
        decode_chunks, decode_chunks_plain, unpack_delta)
    from jpeg_decoder_tpu.ops.pallas_kernels import (_TAIL_TRANSFORMS,
                                                     pallas_tail_mode)
    from jpeg_decoder_tpu_torch.ops.kernels import (dequant_idct,
                                                    dequant_idct_plain,
                                                    fused_tail,
                                                    fused_tail_plain)
    from jpeg_decoder_tpu_torch.ops.pipeline import _planes
    from jpeg_decoder_tpu_torch.params import DeviceParams
    from tools.experiments import fused_recon_probe_torch as k4_probe
    from tools.torch_port_profile import profile as profile_layers

    dev = torch.device("cuda")
    card = card_line()
    say("1 card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        native_host_library=get_native() is not None)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    say("2 build", library=str(lib_path.relative_to(ROOT)),
        nvcc_seconds=_build.build_seconds,
        total_seconds=time.perf_counter() - t0,
        ptxas=[line.split("ptxas info    : ")[-1]
               for line in _build.ptxas_log.splitlines()
               if "registers" in line or "Compiling entry" in line
               or "spill" in line])

    data = {name: (FIXTURES / name).read_bytes() for name in ORDER}
    params = DeviceParams(dev)
    staged = {name: jt.stage_host_bits(data[name]) for name in ORDER}

    def oracle(name):
        d = Decoder(data[name], backend="numpy")
        d._decode_entropy_only()
        return d

    # 3. K1 against its plain version and the host oracle.
    k1_err = 0
    k1_inputs = {}
    for name in ORDER:
        host = oracle(name)
        for st in staged[name].scans:
            words = torch.from_numpy(st.words).to(dev)
            dm = torch.from_numpy(st.dm).to(dev)
            ab, _budget, _slot0, base = unpack_delta(dm)
            args = (words, dm, ab, base, params.tables(st.scan), st.s_max,
                    st.scan.plan.n_blocks)
            k1_inputs.setdefault(name, args)
            nat = decode_chunks(*args)
            plain = decode_chunks_plain(*args)
            torch.cuda.synchronize()
            err = int((nat.to(torch.int32) - plain.to(torch.int32)).abs()
                      .max())
            k1_err = max(k1_err, err)
            stores = assemble_nat(nat, st.scan.plan)
            for pos, comp_i in st.kept:
                want = host._pending_render[comp_i][0].reshape(-1)
                got = stores[pos].reshape(-1).cpu().numpy()
                if err or not np.array_equal(got, want):
                    raise AssertionError(
                        f"K1 {name} component {comp_i}: kernel vs plain max "
                        f"|diff| {err}, oracle mismatches "
                        f"{int((got != want).sum())}")
    say("3 K1 vs plain and oracle", fixtures=len(ORDER), max_abs_err=k1_err,
        result="bit-equal")

    # 4. K2 against its plain version.
    k2_err = 0
    mismatches = 0
    compared = 0
    cases = []
    for name in ORDER:
        host = oracle(name)
        for store, qt in host._pending_render.values():
            cases.append((store.reshape(-1, 64), qt, 8))
    rng = np.random.default_rng(2024)
    qt0 = oracle("large_420.jpg")._pending_render[0][1]
    for scale in (8, 4, 2, 1):
        rand = rng.integers(-1024, 1024, (50000, 64)).astype(np.int16)
        cases.append((rand, qt0, scale))
    for coef_np, qt, scale in cases:
        coef = torch.from_numpy(np.ascontiguousarray(coef_np)).to(dev)
        args = (coef, params.qt(qt), params.basis(scale), scale)
        a = dequant_idct(*args).to(torch.int32)
        b = dequant_idct_plain(*args).to(torch.int32)
        d = (a - b).abs()
        k2_err = max(k2_err, int(d.max()))
        mismatches += int((d > 0).sum())
        compared += d.numel()
    say("4 K2 vs plain", cases=len(cases), pixels=compared,
        mismatches=mismatches, max_abs_err=k2_err, tolerance=K2_TOL)
    if k2_err > K2_TOL:
        raise AssertionError(f"K2 max |diff| {k2_err} > {K2_TOL}")

    # 5. The slice, through the user entry point; counts from this run only.
    torch.cuda.synchronize()
    jt.reset_launches()
    with jt.DeviceStreamDecoder(device="cuda", host_threads=4) as dec:
        images = dec.decode_stream([data[name] for name in ORDER])
        torch.cuda.synchronize()
        launches = dict(jt.LAUNCHES)
        worst = {}
        for name, img in zip(ORDER, images):
            if not (img.is_cuda and img.dtype == torch.uint8):
                raise AssertionError(f"{name}: {img.device} {img.dtype}")
            ref = Decoder(data[name], backend="numpy",
                          precision="exact").decode_array()
            if tuple(img.shape) != ref.shape:
                raise AssertionError(f"{name}: shape {tuple(img.shape)} vs "
                                     f"{ref.shape}")
            diff = np.abs(img.cpu().numpy().astype(np.int32)
                          - ref.astype(np.int32))
            worst[name] = int(diff.max())
            if worst[name] > PIXEL_TOL:
                raise AssertionError(f"{name}: max |diff| {worst[name]} > "
                                     f"{PIXEL_TOL} vs the exact decode")
        if min(launches["huffman_decode"], launches["dequant_idct"]) < 1:
            raise AssertionError(f"a kernel of the path never ran: {launches}")
        say("5 slice", images=len(images), launches=launches,
            max_abs_diff_vs_exact=worst, tolerance=PIXEL_TOL)

        # 6. Times.
        rates = {name: dec.device_resident_rate(data[name], iters=50)
                 for name in ("large_420.jpg", "tower_420.jpg")}
    say("6 device_resident_rate", **rates)

    args1 = k1_inputs["large_420.jpg"]
    k1_ms = cuda_ms(lambda: decode_chunks(*args1), 50)
    k1_plain_ms = cuda_ms(lambda: decode_chunks_plain(*args1), 3)
    luma = oracle("large_420.jpg")._pending_render[0]
    coef = torch.from_numpy(luma[0].reshape(-1, 64)).to(dev)
    args2 = (coef, params.qt(luma[1]), params.basis(8), 8)
    k2_ms = cuda_ms(lambda: dequant_idct(*args2), 50)
    k2_plain_ms = cuda_ms(lambda: dequant_idct_plain(*args2), 50)
    stage_ms = {}
    for name in ORDER:
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jt.stage_host_bits(data[name])
            best = min(best, time.perf_counter() - t0)
        stage_ms[name] = best * 1e3
    say("6 kernel times", k1_shape={"chunks": int(args1[1].numel()),
                                    "n_blocks": args1[6], "s_max": args1[5]},
        k1_ms=k1_ms, k1_plain_ms=k1_plain_ms,
        k2_shape=list(coef.shape), k2_ms=k2_ms, k2_plain_ms=k2_plain_ms)
    say("6 host staging ms/image", **stage_ms)

    # 7. K3 against its plain version: every fixture geometry it takes
    # (planes from the oracle's stores through K2), then seeded planes.
    def fixture_planes(name):
        renders = oracle(name)._pending_render
        geometry = staged[name].geometry
        planes = _planes(
            geometry, [torch.from_numpy(renders[i][0].reshape(-1, 64)).to(dev)
                       for i in range(len(renders))],
            [renders[i][1] for i in range(len(renders))], params)
        chroma = next(((c.size_height, c.size_width)
                       for c in geometry.components
                       if c.upsampler_mode != "h1v1"), None)
        return planes, (tuple(c.upsampler_mode for c in geometry.components),
                        _TAIL_TRANSFORMS[geometry.transform.value],
                        geometry.out_height, geometry.out_width, chroma)

    k3_cases = [fixture_planes(name) for name in ORDER
                if pallas_tail_mode(staged[name].geometry) == "fused"]
    rng = np.random.default_rng(7)
    k3_cases += [(seeded_planes(case, rng, dev), case) for case in TAIL_CASES]
    k3_err = 0
    for planes, (modes, transform, out_h, out_w, chroma) in k3_cases:
        args3 = (planes, modes, chroma, transform, out_h, out_w)
        a = fused_tail(*args3)
        b = fused_tail_plain(*args3)
        if a.shape != (len(planes), out_h, out_w):
            raise AssertionError(f"K3 shape {tuple(a.shape)}")
        k3_err = max(k3_err, int((a.to(torch.int32) - b.to(torch.int32))
                                 .abs().max()))
    say("7 K3 vs plain", cases=len(k3_cases), max_abs_err=k3_err,
        tolerance=0)
    if k3_err:
        raise AssertionError(f"K3 differs from its plain version: {k3_err}")

    # 8. The planar slice, through the user entry point.
    planar_launches, effective = {}, {}
    for layout in ("planar-pallas", "planar"):
        torch.cuda.synchronize()
        jt.reset_launches()
        with jt.DeviceStreamDecoder(device="cuda", host_threads=4,
                                    layout=layout) as dec:
            planar = dec.decode_stream([data[name] for name in ORDER])
            torch.cuda.synchronize()
            planar_launches[layout] = dict(jt.LAUNCHES)
            effective[layout] = {
                name: dec._effective_layout(staged[name].geometry)
                for name in ORDER}
        for name, img, ref in zip(ORDER, planar, images):
            want = ref.permute(2, 0, 1) if ref.dim() == 3 else ref
            if img.shape != want.shape or not torch.equal(img, want):
                raise AssertionError(f"{layout} {name}: differs from the "
                                     f"interleaved image permuted")
    if planar_launches["planar-pallas"]["fused_tail"] < 1:
        raise AssertionError(f"K3 never ran: {planar_launches}")
    say("8 planar slice", images=len(ORDER), launches=planar_launches,
        planar_pallas_takes=effective["planar-pallas"],
        result="bit-equal to interleaved")

    # 9. K4 through its probe; counts from the probe's run only.
    torch.cuda.synchronize()
    jt.reset_launches()
    k4_results = k4_probe.run(FIXTURES / "small_444.jpg", iters=20)
    torch.cuda.synchronize()
    k4_launches = jt.LAUNCHES["fused_recon"]
    for res in k4_results:
        say("9 K4 probe", **res)
        if res["k4_vs_x_max_abs_diff"] != 0 \
                or res["k4_vs_plain_max_abs_diff"] > K4_TOL:
            raise AssertionError(f"K4 {res['case']}: vs K2 path "
                                 f"{res['k4_vs_x_max_abs_diff']}, vs plain "
                                 f"{res['k4_vs_plain_max_abs_diff']}")
    if k4_launches < 1:
        raise AssertionError("K4 never ran in the probe")
    k4_err = max(res["k4_vs_plain_max_abs_diff"] for res in k4_results)
    k4_large = k4_results[-1]

    # 10. Times of the planar tail.
    layer_rates = {}
    for layout in ("interleaved", "planar-pallas"):
        with jt.DeviceStreamDecoder(device="cuda", host_threads=4,
                                    layout=layout) as dec:
            for name in RATE_FIXTURES:
                rate = dec.device_resident_rate(data[name], iters=50)
                prof, _trace = profile_layers(dec, FIXTURES / name, 10)
                layer_rates[f"{layout} {name}"] = {
                    "ms_per_image": rate["ms_per_image"],
                    "host_ms_per_image": rate["host_ms_per_image"],
                    "launches_per_image": prof["launches_per_image"],
                    "device_busy_ms": prof["device_busy_ms"],
                    "layer_kernel_ms": prof["layer_kernel_ms"]}
    say("10 device_resident_rate by layout", **layer_rates)
    planes3, (modes3, transform3, h3, w3, chroma3) = \
        fixture_planes("large_420.jpg")
    args3 = (planes3, modes3, chroma3, transform3, h3, w3)
    k3_ms = cuda_ms(lambda: fused_tail(*args3), 50)
    k3_plain_ms = cuda_ms(lambda: fused_tail_plain(*args3), 50)
    say("10 kernel times", k3_shape={"modes": modes3, "out": [h3, w3],
                                     "chroma": chroma3},
        k3_ms=k3_ms, k3_plain_ms=k3_plain_ms,
        k4_shape={"blocks": k4_large["blocks"], "width": k4_large["width"]},
        k4_ms=k4_large["k4_ms"], k4_plain_ms=k4_large["plain_ms"],
        k4_x_ms=k4_large["x_ms"], floor_ms=k4_large["floor_ms"])

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = [
        {"name": "K1 huffman_decode", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/huffman_decode.cu",
         "replaces": "jpeg_decoder_tpu/entropy/pallas_decode.py:773",
         "launches": launches["huffman_decode"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "K2 dequant_idct", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/dequant_idct.cu",
         "replaces": "jpeg_decoder_tpu/ops/pallas_kernels.py:26",
         "launches": launches["dequant_idct"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "K3 fused_tail", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/fused_tail.cu",
         "replaces": "jpeg_decoder_tpu/ops/pallas_kernels.py:80",
         "launches": planar_launches["planar-pallas"]["fused_tail"],
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms},
        {"name": "K4 fused_recon", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/fused_recon.cu",
         "replaces": "tools/experiments/fused_recon_probe.py:60",
         "launches": k4_launches, "max_abs_err": k4_err,
         "ms": k4_large["k4_ms"], "plain_ms": k4_large["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

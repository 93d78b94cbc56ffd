"""Smoke run of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main path (jpeg_decoder_tpu_torch.DeviceStreamDecoder on
"cuda") over the committed fixtures in tests/fixtures/torch_port/, after
building both hand-written kernels from csrc/ and holding each against its
plain PyTorch version on the card:

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
   path's shapes, and host staging ms/image.

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
         "small_gray.jpg", "small_dri.jpg")
K2_TOL = 1      # fp32 sums in another order: at most one rounding step
PIXEL_TOL = 3   # fast-tier contract against the exact integer decode


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
    from jpeg_decoder_tpu_torch.ops.kernels import (dequant_idct,
                                                    dequant_idct_plain)
    from jpeg_decoder_tpu_torch.params import DeviceParams

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
        total_seconds=time.perf_counter() - t0)

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
        if min(launches.values()) < 1:
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
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Drives the port's paths (jpeg_decoder_tpu_torch.DeviceStreamDecoder on
"cuda" in the interleaved and planar layouts, and the K4 probe
tools/experiments/fused_recon_probe_torch.py) over the committed fixtures
in tests/fixtures/torch_port/, after building every hand-written kernel
from csrc/ and holding each against its plain PyTorch version on the card
(K1-K4, L1, E1, the exact tier's int32 IDCT, T1, the interleaved tail, A1,
the assembly, U1, the delta-wire unpack, P1, the prefix rebuild, and D1, a
stripe's DC totals):

1. card name and power limit (nvidia-smi); the native host library must be
   engaged;
2. kernel build (nvcc), with its time;
3. K1 (Huffman decode) on the card vs its plain version on the card and vs
   the host oracle's coefficient stores, every fixture: bit-equal;
4. K2 (dequant + IDCT) on the card vs its plain version on the card, on
   fixture stores and seeded random coefficients: |diff| <= 1;
5. the slice: decode_stream(all fixtures) -> CUDA tensors, launch counts
   of K1, K2, T1, A1 and U1 > 0, every image within 3 of the host exact decode;
   then [small_444, a malformed stream, small_444] with on_error="none":
   None in the malformed slot, CUDA tensors in the others;
6. CUDA-event times: device-resident ms/image for the 3.4 Mpix and
   512x512 fixtures, each kernel beside its plain version at the main
   path's shapes (K2 over all three components of the 3.4 Mpix image, as
   the main path calls it), K2's yardstick `torch.addmm` (never called by
   the port), and host staging ms/image;
7. K3 (fused upsample + color) vs its plain version on the card, on every
   fixture geometry it takes and on seeded planes (h1v2, YCCK, CMYK 4:4:4,
   CMYK h2v2 on 3 components, width-1 chroma, odd sizes), and on seeded
   planes of every odd width 1-39 and height 1-5 in five layouts, each
   plane's pitch 8 mod 16 or its base 8 bytes off a 16-byte boundary:
   bit-equal;
8. the planar slice: decode_stream(layout="planar-pallas") and "planar"
   over every fixture, each bit-equal to phase 5's interleaved image
   permuted (gray as is), K3 launched in the planar-pallas run;
9. K4 through its probe: bit-equal to K2 + blocks_to_plane + color (the
   same split-TF32 tensor-core product) and within 3 of its plain version,
   on small_444, on seeded stores at its edges (bw past its tiles, a width
   cut mid-block, coefficients >= 2048) and on seeded 256 x 210 block
   stores, K4 launched in the probe's run;
10. times of the planar tail: device-resident ms/image and launches per
   image (profiler) of planar-pallas beside interleaved, and K3 beside its
   plain version at large_420's planes;
11. precision "exact": every fixture, and large_420 scaled 1/2, 1/4 and
   1/8, bit-equal to the host exact decode, with E1 once per image and no
   K2; device-resident ms/image of exact beside fast at large_420, and
   launches per image and device busy time (profiler) of exact beside
   fast, exact no more than 10 launches above fast;
12. progressive and quirk streams (host decode + transcode, then K1):
   large_420_progressive, small_422_progressive and a synthesized quirk
   stream; K1 on the card bit-equal to its plain version and the oracle's
   stores, pixels within 3 (fast) and bit-equal (exact) to the host exact
   decode; the malformed restart_underrun_prescan.jpg raises the host's
   FormatError;
13. large_420 with three (DC, AC) table pairs (the SOF1 recipe, 6 table
   rows) on the anchor wire: K1 bit-equal to plain and the oracle, the
   image equal to the unedited file's;
14. the prefix interchange: every fixture, both precisions, interleaved,
   planar and planar-pallas, bit-equal to the bits path; one large_420
   prefix image at fast, interleaved launching P1 twice, K2 and T1 once
   and nothing else (at most 4 kernels by the profiler, 16 before P1),
   its device half run under
   `torch.cuda.set_sync_debug_mode("error")`;
15. lossless: kernel L1 bit-equal to its plain version and to the host
   oracle for predictors 1-7 x pt {0, 2} on seeded planes of shapes at the
   band edges (L1_SHAPES), and to its plain version on [3, 2048, 2048] at
   predictor 6; a 2048 x 2048 16-bit SOF3 stream (the DICOM "JPEG
   Lossless, First-Order Prediction" class) with predictors 1 and 6, each
   bit-equal to the host decode, and a 3-component 16-bit predictor-6
   stream decoded with exactly one L1 launch; L1 beside its plain version
   at that size, ms/image of the streams, and L1's chain bound: H + W - 1
   steps at the cycles per step and SM clock that
   tools/experiments/l1_step_probe.py measures;
16. the kernel table: each kernel's device time by name (torch.profiler,
   warm L2) at the main path's shapes beside its bound (the larger of its
   bytes over 3.35 TB/s and its operations over the peak rate of their
   type; for L1 also its chain bound from phase 15; for K2 and K4, whose
   bound is bytes, also the TF32 work and the fp32 CUDA-core time of the
   same product), K2's yardstick `torch.addmm` and K4's, the unfused K2
   path, by device time over every kernel they launch, and its launches
   per image on the main path (one large_420 decode: bits, fast,
   interleaved; for E1 the same decode at exact; K1, A1 and U1 once per
   call, and K2, E1, T1, A1 and U1 once per image); E1's bound counts
   E1_OPS_PER_BLOCK int32 operations a block at INT32_OPS, a multiply-add
   counted as two operations against a peak of two a lane a clock;
17. batched dispatch, decode_stream(batch_size=N): tower_420 x 32 at 16,
   large_420 x 4 at 4, the six ImageNet-class mixed sizes (plus two
   repeats) at 8 at both precisions, tower_420 x 8 at 8 at precision
   "exact", on the prefix interchange at both precisions and in layout
   "planar-pallas", and eight 512 x 512 16-bit SOF3 slices at 8 with
   predictors 1 and 6: every image bit-equal to its batch_size=1 decode,
   the launches per group counted (K1 1 per group, K2 1 per plan at fast,
   E1 1 per plan at exact, K3 1 per plan on planar-pallas, L1 1 at
   predictor 6, P1 2 per prefix group); the
   on_error stream inside a batch; batched K2 (48 segments with per-image
   tables, and 3 merged) and K3 (16 images) SHA-256-equal to per-image
   launches; device-resident ms/image and launches/image of tower_420 at
   batch 1, 4 and 16 and large_420 at 4, and of tower_420 at exact at 1
   and 16; each kernel's device time at its batched shape (E1 too) beside
   its bytes bound;
18. the front end and the service: `Decoder(backend="torch")` over every
   fixture and small_422_progressive, bit-equal to the host decode at
   "exact" (E1 once per image) and within 3 at "fast" (K2 launched),
   large_420 scaled 1/2,
   1/4 and 1/8 at both precisions; the 2048 x 2048 16-bit SOF3 stream at
   predictors 1 and 6 and the 768 x 1024 x 3 one at predictor 6,
   bit-equal, L1 once per component at predictor 6; backend "auto" with no
   launch on an image of at most 128 x 128 (small_gray at 1/8, a 96 x 96
   SOF3) and K2 on tower_420 at "fast"; `BatchDecodeService` equal byte
   for byte to the per-image `Decoder`, E1 once per image;
   `decode_stream(timer=StageTimer())` of tower_420 x 64 at batch 16 and
   large_420 x 4 at batch 4, twice, SHA-256-equal across the runs and to
   the run without a timer, with "host_stage", "h2d_submit" and
   "device_dispatch" counted; times: `Decoder.decode` ms/image of
   large_420 and tower_420 by backend and precision with its split (host
   entropy, H2D, device enqueue, D2H) and the reconstruction's CUDA-event
   time, the stream's h2d_submit ms and bytes/s per image and its
   pageable-to-pinned copy time, pinned against pageable H2D rates,
   `utils.link.probe()`'s reading and the pinned pool's peak bytes;
19. the mesh (`jpeg_decoder_tpu_torch.parallel`), on slots of the card
   (a mesh may name one device several times; on a machine with more
   cards the slots go round them): large_420 through
   `DeviceStreamDecoder(mesh=...).decode_striped` at 4 and 8 stripes,
   bit-equal to the host exact decode with K1, E1, T1, A1 and D1 launched
   once per stripe and no U1 (the stripes' wires are anchor wires);
   K1 bit-equal to its plain version on every stripe wire of large_420 at
   4 and 8 stripes and of stripe_420.jpg at 8 (first blocks negative);
   tower_420 x 16 at batch 16 on {"data": 4}, a prefix group of tower_420
   x 8 and eight 512 x 512 16-bit SOF3 slices (predictor 6) at batch 8 on
   {"data": 4}, every image SHA-256-equal to the meshless decode, with K1,
   K2 and L1 once per shard; 4 x tower_420 through
   `decode_bits_striped_batch` on {"data": 2, "stripe": 2} (E1 once per
   shard and stripe); the service on the fixtures with a mesh, equal to
   the meshless service (E1 once per image); and
   `parallel.dryrun.dryrun_multichip(4, ["cuda:0"] * 4)`. Times (each
   beside the card's name and power limit): CUDA-event ms per image and
   per stripe of the striped decode's device half at 4 and 8 stripes
   beside the meshless exact decode's, launches per image and per stripe
   (beside the parent's, 26.75 and 30.875 before D1),
   the halo, carry and gather bytes,
   and each DP shard's device ms;
20. the mesh across two processes: `tools/multiproc_mesh_torch.py --device
   cuda`, two ranks joined by torch.distributed (gloo over 127.0.0.1), each
   driving 4 slots of the card, every exchange between them staged through
   host memory: DP over "data"=8 with each rank staging its own rows, SP
   over "stripe"=8 with the halo across the process seam, tower_420 and
   tower_420_q92 in a prefix group (exact) and a bits group (fast), eight
   512 x 512 16-bit SOF3 slices (predictor 6), and large_420 and
   stripe_420.jpg striped over 8 with entropy decode (the DC carry and the
   halo across the seam). Per rank: every phase bit-equal to the same
   decode in that process, K1, K2 and L1 launched once per shard, stripe or
   plan as the phase says, K1 bit-equal to its plain version on the rank's
   own stripe wires, the bytes that crossed between the processes by kind,
   and the CUDA-event ms of the striped large_420 decode beside phase 19's
   one-process figure. A rank's failure or timeout fails the run;
21. the mutation fuzzer on the card (`tools/fuzz_torch.py`'s device mode
   over 300 sources, about 70% of them mutants writing 1-8 bytes after the
   first SOS header, in streams of 6): `decode_stream(on_error="none")` at
   batch 1 and 4 on bits/prefix x fast/exact, planar-pallas at bits/fast,
   and `Decoder(backend="torch")`, every source against the host oracle
   (the same typed error, exact and lossless bit-equal, fast within 3,
   batches bit-equal to batch 1); K1 bit-equal to the oracle's stores and
   to its plain version on the card on every staged scan, launched once
   per scan; K3 and L1 bit-equal to their plain versions on mutated input,
   each launched at least once. Prints the counts (mutants, accepted,
   fallbacks, lossless, typed errors, failures, fast misses), K1, K2, K3,
   L1, E1, T1, A1 and U1 launches under the fuzz (E1 in the exact legs,
   each launched at least once) and the seconds; any failure fails the
   run. Where `compute-sanitizer` is on PATH and its memcheck runs a
   control (one `torch.ones` on the card) clean, 50 more sources run under
   it in a subprocess and any report fails the run; where it is absent, or
   fails the control (the H100 machine's reports "Device not supported"),
   the phase says so;
22. the tools: `tools/scaling_bench_torch.py`'s sweep at 1, 2 and 4 slots
   of the card on large_420 (DP throughput, fixed-batch and stripe-bits
   overhead: ms, Mpix/s, launches per image, t1/tN, every output
   bit-equal), and `examples/decode_torch.py` writing tower_420 (exact and
   fast) and a 512 x 512 16-bit SOF3 stream (predictor 6) to PNGs under
   chiprun_out/, each read back equal to `Decoder(backend="numpy")` (fast
   within 3), K2 launched at fast, E1 at exact and L1 on the SOF3 stream;
23. E1 (the exact tier's int32 IDCT, csrc/idct_exact.cu) against its
   plain version on the card and on the CPU, tolerance 0: scales 8/4/2/1
   on `tests/torch_inputs.py::adversarial_blocks` (16-bit tables times
   full-range coefficients) and on every fixture's stores; 16 images x 3
   components with per-image tables (48 segments) in one launch,
   SHA-256-equal to per-image launches; 17 x 4 segments in two launches;
   a store off a 16-byte boundary refused; one E1 launch for one exact
   large_420 decode; E1's CUDA-event ms at large_420's shapes beside its
   plain version's;
24. T1 (the interleaved tail, csrc/interleaved_tail.cu: block pixels ->
   the upsampled, color-converted image) against its plain version on the
   card, tolerance 0: every T1 call of real decodes as the decode makes
   it (every fixture at fast and exact, interleaved and planar; large_420
   at 1, 1/2, 1/4 and 1/8; a tower_420 group of 16; the hetero group;
   the stripes of large_420 at 4 and 8 and of stripe_420.jpg at 8, one
   call per stripe), seeded pixels at every odd width 1-39 and height 1-5
   per layout and transform, and `tests/torch_inputs.py::T1_CASES`
   (scales 8/4/2/1, groups of 3, the edges of the kernel's 16 x 128
   tiles), interleaved and planar; T1's CUDA-event ms at large_420's
   shapes beside its plain version's; T1's device time per launch
   (torch.profiler, 100 calls: median, least, largest) beside its bytes
   bound for large_420 at fast and exact and planar, the tower_420 group
   of 16, a large_420 stripe, and seeded 4:4:4, 4:2:2 and gray images of
   large_420's size. T1's launches are
   checked in phases 5 (> 0), 11 (1 per image), 16 (1 per large_420 image
   at fast and exact), 17 (1 per plan), 18 (1 per image), 19 (1 per
   stripe) and 21 (> 0);
25. A1 (the assembly, csrc/assemble.cu: stream-order nat -> the
   components' stores, the DC prefix sums by decoupled look-back, padding
   zeroed) and U1 (the delta-wire unpack, csrc/unpack_delta.cu) against
   their plain versions on the card, tolerance 0: every A1 and U1 call of
   real decodes, captured by spies on `models/stream.py` and
   `parallel/stripe_bits.py` (every fixture at fast and exact, small_dri's
   restart segments among them; a tower_420 group of 16; the hetero
   group; the progressive fixtures, the quirk stream and the three-pair
   large_420; the stripes of large_420 at 4 and 8 and of stripe_420.jpg
   at 8, each A1 call with its carry, one per stripe); `tests/
   torch_inputs.py::A1_CASES` (padded grids, restart segments across the
   kernel's tiles, 36-tile sequences, groups, carries with high bits set,
   general maps) with and without carries, every fixture's plan through
   the general branch, and U1 on seeded wires of 1 to 2^20 + 1 entries
   (one tile to 129 of its tiles), and on the merged wires of large_420
   x4 and x16 (`decode_stream(batch_size=4 and 16)`: one U1 launch over
   more than one tile each); A1's and U1's CUDA-event ms at large_420
   beside their plain versions (U1 also beside `torch.cumsum` over its
   two columns, int32 [2, n]), and their device time per launch
   (torch.profiler, 100 calls: median, least, largest) beside the bytes
   bound: A1 at large_420, over a tower_420 group of 16 and on a large_420
   stripe; U1 on large_420's wire, tower_420 x16's and large_420 x16's
   merged wires and wires of 65,536 and 1,048,576 entries, each beside
   `torch.cumsum`'s device time and the launch floor (U1's kernel built
   with its body taken out, launched the same way). A1's and U1's
   launches are checked in phases 5 (> 0), 16 (1 per large_420 image at
   fast and exact), 19 (A1 1 per stripe, U1 none) and 21 (> 0);
26. P1 (the prefix rebuild, csrc/prefix_rebuild.cu: the prefix wire ->
   the stores, a base pass of a tile a CTA, then a residual pass) and D1
   (a stripe's DC totals, csrc/dc_totals.cu: a thread a block's DC, int64
   accumulators that count their arrivals) against their plain versions
   on the card, tolerance 0: every P1 and D1 call of the real decodes of
   phases 14, 17, 19, 21 and 22, captured by spies on `models/stream.py`
   and `parallel/stripe_bits.py` and checked after each phase, and here
   the in-process counterparts of phase 20's (a prefix group of tower_420
   and tower_420_q92 on {"data": 8} slots at exact, stripe_420.jpg
   striped over 8) and the q100 fixture through the prefix route; seeded
   P1 wires (duplicate, out-of-range and negative indices, an empty
   residual list, both halves of a 32-bit word, block counts around its
   tiles, an AC array off 16 bytes) and prefix groups of 1 to 16
   tower_420; seeded D1 nat of every fixture's plan and large_420's
   stripe plans at 4 and 8. Times: P1's and D1's CUDA-event ms beside their
   plain versions' (D1 also beside `dc.sum(1)` over its DC view), their
   device µs by name (P1's two passes apart; median, least and largest
   of the launches) at large_420, over a tower_420 group of 16 and on
   large_420 stripes at 4 and 8, beside the bytes bound. Their launches
   are checked in phases 14 (P1 2 per image), 17 (2 per prefix group), 19
   (D1 1 per stripe, P1 2 per prefix shard) and 20 (per rank);
27. the matrix: the main path along the host switches of
   `tools/ci_matrix_torch.sh` (MATRIX_LEGS: the pure-Python entropy
   engine, the speculative prescan split forced at 4 KiB, class collapse
   off). large_420 (bits, interleaved) at fast and at exact, tower_420 x 16
   at batch 16, the mixed sizes at batch 8, stripe_420.jpg on
   {"stripe": 4} slots of the card and q100_420.jpg on the prefix
   interchange, decoded here with the default switches and then once per
   leg by `python3 chip_smoke.py --matrix-leg` in a subprocess started with
   the leg's switch: every output SHA-256-equal to the default decode,
   every K1, U1, A1, P1 and D1 call of each leg bit-equal to its plain
   version, K1, U1, A1, K2, T1, E1, P1 and D1 launched in each leg, and the
   native host library engaged in every leg but the engine's; each leg's
   seconds, launches and whether K1 and P1 read the default's wire (class
   collapse off changes the delta wire). Phase 1 requires the native host
   library;
28. the compiled dispatch (`jpeg_decoder_tpu_torch/models/graphs.py`: the
   bits, prefix and lossless device halves captured once per key as CUDA
   graphs and replayed; phases 5-27 already decode through it, their spies
   seeing each key's eager warm-up and not its capture): bits large_420 at
   fast and exact in the three layouts and tower_420 at batch 1 and 16,
   prefix large_420 likewise and tower_420 x 16, lossless SOF3 512 x 512
   x 8 and 2048 x 2048 at predictors 1 and 6 (GRAPH_ROUTES), every
   replay SHA-256-equal to the eager body on the same inputs, with its
   launches (on the prefix and lossless routes also every kernel by name
   as often as in the eager body, and replays under
   `set_sync_debug_mode("error")`); tower_420, tower_420_q92 and the
   optimised-table tower_420
   alternating (two keys), every tensor handed out unchanged after later
   replays; 10,000 replays of one graph and a replay run across the end
   of the device epochs (A1's 2^32, U1's 2^30); replays under
   `set_sync_debug_mode("error")`; the profiler's count of each kernel
   over replays, equal to the eager body's launches on every route; each
   graph's pool and peak memory; eager beside replay,
   device-resident ms/image, host ms/image and the card's idle share, and
   each eager wrapper's host µs beside its kernel.

Any failure raises and the script exits nonzero. It needs a CUDA device and
the repository around it; it imports neither JAX, nor PIL, nor the JAX
package: the host oracle is the port's own copy (`jpeg_decoder_tpu_torch.
host`). The last line is
{"ok": true, "device": {...}}; the line before it is nvidia-smi's card
name and power limit, before that a JSON line with one entry per kernel,
and before that phase 27's {"matrix": {...}} line.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import json
import os
import shutil
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
K4_X_TOL = 0    # K4 vs the K2 path: the same split-TF32 IDCT arithmetic
K4_TOL = 3      # K4 vs its plain version: 1 in the IDCT, x1.772 in color
BAD_JPEG = b"\xff\xd8 definitely not a jpeg"   # on_error's malformed item
RATE_FIXTURES = ("large_420.jpg", "tower_420.jpg")
PROGRESSIVE = ("large_420_progressive.jpg", "small_422_progressive.jpg")
EXACT_SCALES = ((1024, 840), (512, 420), (256, 210))   # large_420 / 2, 4, 8
L1_PLANE = (1, 384, 256)      # seeded difference planes, predictor x pt
# L1 at the edges of its 32-row bands and 16-column strips, (C, H, W).
L1_SHAPES = ((1, 1, 70), (1, 31, 45), (1, 32, 9), (1, 33, 200), (3, 97, 1),
             (1, 1100, 3))
L1_FULL = (3, 2048, 2048)     # predictor 6 only: plain takes ~1.4 s a plane
SOF3_SIDE = 2048              # the full-size lossless stream: 2048 x 2048
SOF3_RGB = (768, 1024)        # the 3-component lossless stream
SOF3_SLICE = (512, 512)       # 17: a CT series' 16-bit slices
FRONT_SCALES = ((1024, 840), (512, 420), (256, 210))   # 18: large_420 / 2..8
H2D_SIZES = (64 << 10, 1 << 20, 8 << 20)    # 18: pinned vs pageable copies
MIXED = tuple(f"mixed_{w}x{h}.jpg" for w, h in (
    (500, 375), (375, 500), (500, 333), (333, 500), (448, 448), (320, 240)))
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W):
# the least time of a kernel is the larger of its bytes over HBM_BPS and its
# operations over the peak rate of their type.
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12   # tensor cores; K2's split product takes 3 TF32 products
# int32 on the CUDA cores: 132 SMs x 64 INT32 lanes x 1.98 GHz (boost),
# each lane doing one IMAD, IADD3 or LEA a clock, which E1_OPS_PER_BLOCK
# counts as two operations (a multiply and its add, two adds, a shift and
# its add): two operations a lane a clock, as FP32_FLOPS counts an FMA.
INT32_OPS = 2 * 132 * 64 * 1.98e9
# E1's int32 operations per block at scale 8, counted from
# csrc/idct_exact.cu, every multiply, add, shift and compare as one:
# dequantize 64 products; the shortcut's test 56 compares and 56 ORs (rows
# 1-7 of 8 columns); the column pass 8 x 58 (`pass8`: 18 even, 24 odd, 16
# sums and shifts) and 8 x 9 for the shortcut (dc << 2, 8 selects); the
# row pass 8 x 58; the clamp 2 a pixel.
E1_OPS_PER_BLOCK = 64 + 56 + 56 + 8 * 58 + 8 * 9 + 8 * 58 + 2 * 64
E1_GROUP = (16, (4096, 1024, 1024))   # 23: tower_420's stores x 16 images
E1_ADVERSARIAL = 30000                # 23: blocks per seed and scale
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


def capturing() -> bool:
    """True while a CUDA graph is being captured (`models/graphs.py`): a
    spy then sees calls that launch nothing, whose tensors hold no values
    until a replay, so it leaves them out; it sees the key's eager warm-up
    call, on the same inputs, just before."""
    return torch.cuda.is_current_stream_capturing()


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


def odd_tail_cases(rng, dev) -> list:
    """K3 at every odd width 1-39 and height 1-5 in the five layouts of
    `tests/torch_inputs.py::ODD_TAIL_LAYOUTS`, every plane's pitch 8 mod 16
    or (every other case) its base 8 bytes off a 16-byte boundary."""
    from torch_inputs import ODD_TAIL_LAYOUTS, odd_tail_case

    cases = []
    for out_w in range(1, 40, 2):
        for out_h in range(1, 6):
            for layout in ODD_TAIL_LAYOUTS:
                planes, modes, chroma, transform, h, w = odd_tail_case(
                    layout, out_h, out_w, 8 * (len(cases) % 2), rng, dev)
                cases.append((planes, (modes, transform, h, w, chroma)))
    return cases


def host_exact(data: bytes, scale_to=None) -> np.ndarray:
    from jpeg_decoder_tpu_torch.host.decoder import Decoder

    d = Decoder(data, backend="numpy", precision="exact")
    if scale_to is not None:
        d.scale(*scale_to)
    return d.decode_array()


def host_oracle(data: bytes):
    """The host oracle's decoder, entropy-decoded: its stores in
    `_pending_render`."""
    from jpeg_decoder_tpu_torch.host.decoder import Decoder

    d = Decoder(data, backend="numpy")
    d._decode_entropy_only()
    return d


def max_diff(img: torch.Tensor, ref: np.ndarray, what: str) -> int:
    got = img.cpu().numpy()
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {got.shape} vs {ref.shape}")
    return int(np.abs(got.astype(np.int64) - ref.astype(np.int64)).max())


def k1_stores(st, params, dev):
    """K1 on the card and its plain version on one staged scan (either
    wire), both checked against each other; returns (max |diff|, the
    scan's stores from the kernel, the K1 arguments)."""
    from jpeg_decoder_tpu_torch.entropy.assemble import (GeneralMaps,
                                                         assemble_nat)
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import (
        decode_chunks, decode_chunks_plain, unpack_delta)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    words, dm = put(st.words), put(st.dm)
    if st.ab is None:
        ab, base = unpack_delta(dm)
    else:
        ab, base = put(st.ab), put(st.base)
    plan = st.scan.plan
    args = (words, dm, ab, base, params.tables(st.scan), st.s_max,
            plan.n_blocks)
    nat = decode_chunks(*args)
    plain = decode_chunks_plain(*args)
    torch.cuda.synchronize()
    err = int((nat.to(torch.int32) - plain.to(torch.int32)).abs().max())
    maps = None if plan.structured is not None else GeneralMaps(plan, dev)
    return err, assemble_nat(nat, plan, maps), args


def check_stores(name: str, data: bytes, staged, params, dev) -> int:
    """K1 vs plain and the oracle's stores for every scan of `staged`, the
    staging of `data`."""
    host = host_oracle(data)
    worst = 0
    for st in staged.scans:
        err, stores, _args = k1_stores(st, params, dev)
        worst = max(worst, err)
        for pos, comp_i in st.kept:
            want = host._pending_render[comp_i][0].reshape(-1)
            got = stores[pos].reshape(-1).cpu().numpy()
            if err or not np.array_equal(got, want):
                raise AssertionError(
                    f"K1 {name} component {comp_i}: kernel vs plain max "
                    f"|diff| {err}, oracle mismatches "
                    f"{int((got != want).sum())}")
    return worst


def bound(nbytes: float, flops: float = 0.0, rate: float = FP32_FLOPS
          ) -> tuple:
    """(least µs, "bytes" or "operations") for `nbytes` moved and `flops`
    done at `rate`."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e6, flops / rate * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path_launches(jt, blob: bytes, precision: str = "fast") -> dict:
    """Kernel launches of one large_420 decode on the main path: bits
    interchange, interleaved, at `precision` (fast, or exact for E1)."""
    with jt.DeviceStreamDecoder(host_threads=1, precision=precision) as dec:
        staged = dec.stage(blob)
        wires = dec._to_device(staged)
        torch.cuda.synchronize()
        jt.reset_launches()
        dec._run_device(staged, wires)
        torch.cuda.synchronize()
        return dict(jt.LAUNCHES)


def phase_kernel_table(jt, measured: dict, per_image: dict, l1_chain: dict,
                       yardsticks: dict) -> list:
    """16. Device time of each kernel by name (torch.profiler, warm L2) at
    the main path's shapes, beside its bound; `measured[name]` holds (the
    wrapper call, the kernel's symbol, bytes, flops, flop rate). A kernel
    whose flops are TF32 split products (three per fp32 product) also gets
    the TF32 work and the fp32 CUDA-core time of that product. L1 also gets
    its chain bound, and each `yardsticks[name] = (label, call)` (K2's
    `torch.addmm`, K4's unfused K2 path) its device time over every kernel
    it launches, as `{label}_device_us`."""
    from tools.torch_port_profile import kernel_device_us

    rows = {}
    for name, (fn, symbol, nbytes, flops, rate) in measured.items():
        prof = kernel_device_us(fn, symbol)
        least, by = bound(nbytes, flops, rate)
        rows[name] = {"kernel_us": prof["kernel_us"],
                      "kernel_launches_per_call": prof["launches"],
                      "wrapper_device_us": prof["all_device_us"],
                      "wrapper_launches_per_call": prof["all_launches"],
                      "bound_us": least, "bound_by": by,
                      "launches_per_image": per_image[name]}
        if rate == TF32_FLOPS:
            rows[name]["tf32_work_us"] = flops / TF32_FLOPS * 1e6
            rows[name]["fp32_core_bound_us"] = flops / 3 / FP32_FLOPS * 1e6
    rows["L1"]["chain_bound_us"] = l1_chain["chain_bound_us"]
    rows["L1"]["bound_with_chain_us"] = max(rows["L1"]["bound_us"],
                                            l1_chain["chain_bound_us"])
    for name, (label, call) in yardsticks.items():
        prof = kernel_device_us(call, "")
        rows[name][f"{label}_device_us"] = prof["all_device_us"]
        rows[name][f"{label}_launches_per_call"] = prof["all_launches"]
    say("16 kernel table", **rows)
    if any(per_image[k] != 1 for k in ("K2", "E1", "T1", "A1", "U1")) \
            or any(rows[k]["wrapper_launches_per_call"] != 1
                   for k in ("K1", "A1", "U1")):
        raise AssertionError("K2 (fast), E1 (exact), T1, A1 and U1 must "
                             "launch once per image and the K1, A1 and U1 "
                             f"wrappers once per call: {rows}")
    return rows


def phase_exact(jt, data: dict, profile_layers) -> dict:
    """11. Precision "exact" through the user entry point: E1 once per
    image; returns the launches of the run."""
    large = data["large_420.jpg"]
    torch.cuda.synchronize()
    jt.reset_launches()
    with jt.DeviceStreamDecoder(device="cuda", host_threads=4,
                                precision="exact") as dec:
        images = dec.decode_stream([data[name] for name in ORDER])
        scaled = [dec.decode_stream([large], scale_to=s)[0]
                  for s in EXACT_SCALES]
        torch.cuda.synchronize()
        launches = dict(jt.LAUNCHES)
        for name, img in zip(ORDER, images):
            if max_diff(img, host_exact(data[name]), name):
                raise AssertionError(f"exact {name} differs from the host")
        for size, img in zip(EXACT_SCALES, scaled):
            if max_diff(img, host_exact(large, size), f"large {size}"):
                raise AssertionError(f"exact large_420 at {size} differs")
        if launches["huffman_decode"] < 1 or launches["dequant_idct"] \
                or launches["idct_exact"] != len(images) + len(scaled) \
                or launches["interleaved_tail"] != len(images) + len(scaled):
            raise AssertionError(f"K1 never ran, K2 ran, or E1 or T1 not "
                                 f"once per image: {launches}")
        exact = dec.device_resident_rate(large, iters=20)
        prof, _trace = profile_layers(dec, FIXTURES / "large_420.jpg", 10)
    with jt.DeviceStreamDecoder(device="cuda", host_threads=4) as dec:
        fast = dec.device_resident_rate(large, iters=20)
        fast_prof, _trace = profile_layers(dec, FIXTURES / "large_420.jpg",
                                           10)
    if prof["launches_per_image"] > fast_prof["launches_per_image"] + 10:
        raise AssertionError(
            f"exact takes {prof['launches_per_image']} launches per image, "
            f"more than 10 above fast's {fast_prof['launches_per_image']}")
    say("11 exact", images=len(ORDER) + len(EXACT_SCALES),
        scales=EXACT_SCALES, launches=launches, result="bit-equal to host",
        large_420_exact_ms=exact["ms_per_image"],
        large_420_exact_host_ms=exact["host_ms_per_image"],
        large_420_fast_ms=fast["ms_per_image"],
        large_420_fast_host_ms=fast["host_ms_per_image"],
        exact_launches_per_image=prof["launches_per_image"],
        fast_launches_per_image=fast_prof["launches_per_image"],
        exact_device_busy_ms=prof["device_busy_ms"],
        fast_device_busy_ms=fast_prof["device_busy_ms"],
        exact_layer_kernel_ms=prof["layer_kernel_ms"],
        exact_top_kernels_ms=prof["top_kernels_ms"])
    return launches


def phase_transcoded(jt, data: dict, params, dev) -> int:
    """12. Progressive and quirk streams: host decode + transcode, K1."""
    from torch_inputs import quirk_jpeg
    from jpeg_decoder_tpu_torch.host.errors import FormatError

    cases = {name: (FIXTURES / name).read_bytes() for name in PROGRESSIVE}
    cases["quirk_jpeg(0)"] = quirk_jpeg(0)
    k1_err = 0
    for name, blob in cases.items():
        staged = jt.stage_host_bits(blob)
        if not isinstance(staged, jt.StagedBits):
            raise AssertionError(f"{name} staged as {type(staged)}")
        k1_err = max(k1_err, check_stores(name, blob, staged, params, dev))
    worst = {}
    launches = {}
    for precision in ("fast", "exact"):
        torch.cuda.synchronize()
        jt.reset_launches()
        with jt.DeviceStreamDecoder(device="cuda", host_threads=4,
                                    precision=precision) as dec:
            images = dec.decode_stream(list(cases.values()))
            torch.cuda.synchronize()
        launches[precision] = dict(jt.LAUNCHES)
        if launches[precision]["huffman_decode"] < len(cases):
            raise AssertionError(f"K1 launches {launches[precision]}")
        for name, img in zip(cases, images):
            worst[f"{precision} {name}"] = err = max_diff(
                img, host_exact(cases[name]), name)
            if err > (PIXEL_TOL if precision == "fast" else 0):
                raise AssertionError(f"{precision} {name}: max |diff| {err}")
    bad = (ROOT / "tests" / "fixtures" / "restart_underrun_prescan.jpg") \
        .read_bytes()
    try:
        host_exact(bad)
        raise AssertionError("the host decoded restart_underrun_prescan")
    except FormatError as e:
        host_msg = str(e)
    try:
        with jt.DeviceStreamDecoder(device="cuda", host_threads=1) as dec:
            dec.decode_stream([bad])
        raise AssertionError("the port decoded restart_underrun_prescan")
    except FormatError as e:
        if str(e) != host_msg:
            raise AssertionError(f"port raised {e!r}, host {host_msg!r}")
    with jt.DeviceStreamDecoder(device="cuda", host_threads=4) as dec:
        rate = dec.device_resident_rate(cases[PROGRESSIVE[0]], iters=20)
    say("12 progressive and quirk", k1_vs_plain_max_abs_err=k1_err,
        stores="bit-equal to the oracle", max_abs_diff_vs_exact=worst,
        launches=launches, underrun_fixture=f"raises {host_msg!r}",
        large_420_progressive_ms=rate["ms_per_image"],
        large_420_progressive_host_ms=rate["host_ms_per_image"])
    return k1_err


def phase_three_pairs(jt, data: dict, params, dev) -> int:
    """13. large_420 with three (DC, AC) table pairs, the anchor wire."""
    from torch_inputs import three_table_pairs

    blob = three_table_pairs(data["large_420.jpg"])
    staged = jt.stage_host_bits(blob)
    (st,) = staged.scans
    n_tab = params.tables(st.scan).n_tab
    if st.wire != "anchor" or n_tab != 6:
        raise AssertionError(f"wire {st.wire}, {n_tab} table rows")
    k1_err = check_stores("large_420 three pairs", blob, staged, params, dev)
    _err, _stores, args = k1_stores(st, params, dev)
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import (
        decode_chunks, decode_chunks_plain)
    k1_ms = cuda_ms(lambda: decode_chunks(*args), 50)
    k1_plain_ms = cuda_ms(lambda: decode_chunks_plain(*args), 2)
    torch.cuda.synchronize()
    jt.reset_launches()
    with jt.DeviceStreamDecoder(device="cuda", host_threads=1,
                                precision="exact") as dec:
        img = dec.decode_stream([blob])[0]
        torch.cuda.synchronize()
        launches = dict(jt.LAUNCHES)
        if max_diff(img, host_exact(data["large_420.jpg"]), "three pairs"):
            raise AssertionError("three-pair large_420 differs from large_420")
        rate = dec.device_resident_rate(blob, iters=20)
    if launches["huffman_decode"] < 1:
        raise AssertionError(f"K1 never ran: {launches}")
    say("13 three table pairs", wire=st.wire, table_rows=n_tab,
        chunks=int(st.dm.size), s_max=st.s_max, k1_vs_plain_max_abs_err=k1_err,
        stores="bit-equal to the oracle",
        image="equal to the unedited large_420", launches=launches,
        k1_anchor_ms=k1_ms, k1_anchor_plain_ms=k1_plain_ms,
        exact_ms=rate["ms_per_image"])
    return k1_err


def phase_prefix(jt, data: dict) -> dict:
    """14. The prefix interchange against the bits path, in every layout at
    both precisions; the launches of one large_420 prefix image by kernel
    (P1, K2, T1) and in all (profiler), and its device half run under
    `torch.cuda.set_sync_debug_mode("error")`. Returns the launches of the
    prefix runs."""
    from tools.torch_port_profile import kernel_device_us

    names = ORDER + PROGRESSIVE
    blobs = [data.get(n) or (FIXTURES / n).read_bytes() for n in names]
    launches = {}
    for precision in ("fast", "exact"):
        for layout in ("interleaved", "planar", "planar-pallas"):
            out = {}
            for interchange in ("bits", "prefix"):
                torch.cuda.synchronize()
                jt.reset_launches()
                with jt.DeviceStreamDecoder(
                        device="cuda", host_threads=4, precision=precision,
                        layout=layout, interchange=interchange) as dec:
                    out[interchange] = dec.decode_stream(blobs)
                    torch.cuda.synchronize()
                launches[f"{interchange} {precision} {layout}"] = \
                    dict(jt.LAUNCHES)
            for name, a, b in zip(names, out["prefix"], out["bits"]):
                if a.shape != b.shape or not torch.equal(a, b):
                    raise AssertionError(f"prefix {precision} {layout} "
                                         f"{name} differs from bits")
    if launches["prefix fast interleaved"]["dequant_idct"] < 1 \
            or launches["prefix fast interleaved"]["prefix_rebuild"] < 1:
        raise AssertionError(f"K2 or P1 never ran on prefix: {launches}")

    # One large_420 prefix image: P1's two launches, K2 and T1, nothing
    # else; no operation of its device half waits for the card.
    with jt.DeviceStreamDecoder(host_threads=1,
                                interchange="prefix") as dec:
        staged = dec.stage(data["large_420.jpg"])
        wires = dec._to_device(staged)
        dec._run_device(staged, wires)
        _img, one = counted(jt, lambda: dec._run_device(staged, wires))
        every = kernel_device_us(lambda: dec._run_device(staged, wires),
                                 "prefix_base_kernel")["all_launches"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            dec._run_device(staged, wires)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    ours = {k: v for k, v in one.items() if v}
    if ours != {"prefix_rebuild": 2, "dequant_idct": 1,
                "interleaved_tail": 1} or every > 4:
        raise AssertionError(f"14 a large_420 prefix image launched {ours}, "
                             f"{every} kernels in all")
    rates = {}
    for precision in ("fast", "exact"):
        with jt.DeviceStreamDecoder(device="cuda", host_threads=4,
                                    precision=precision,
                                    interchange="prefix") as dec:
            rates[f"large_420 {precision}"] = dec.device_resident_rate(
                data["large_420.jpg"], iters=20)["ms_per_image"]
    say("14 prefix", images=len(names), result="bit-equal to bits",
        launches=launches, prefix_ms=rates,
        large_420_prefix_image={"launches_by_kernel": ours,
                                "launches_in_all": every,
                                "launches_in_all_before_p1": 16,
                                "sync_debug_error": "nothing raised"})
    return launches["prefix fast interleaved"]


def l1_chain_bound(h: int, w: int) -> dict:
    """L1's chain bound for an h x w plane: H + W - 1 dependent steps at
    the cycles of one step and the SM clock l1_step_probe measures."""
    from tools.experiments import l1_step_probe

    step = l1_step_probe.measure_step()
    return {**step, "steps": h + w - 1,
            "chain_bound_us": (h + w - 1) * step["step_cycles"]
            / step["sm_clock_mhz"]}


def phase_lossless(jt, dev) -> tuple:
    """15. Lossless: L1 against its plain version and the oracle, then a
    2048 x 2048 16-bit SOF3 stream with predictors 1 and 6."""
    from jpeg_decoder_tpu_torch.host.ops.predictors import (
        _default_prediction, reconstruct_lossless)
    from jpeg_decoder_tpu_torch.host.parser import Predictor
    from jpeg_decoder_tpu_torch.ops.predictors import (lossless_recur,
                                                       lossless_recur_plain)
    from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

    rng = np.random.default_rng(15)
    l1_err = 0
    l1_cases = 0
    for shape in (L1_PLANE, *L1_SHAPES, L1_FULL):
        for predictor in (6,) if shape == L1_FULL else range(1, 8):
            for pt in (0, 2):
                d_np = rng.integers(-200, 200, shape)
                d_np[..., ::7] = rng.integers(0, 65536, d_np[..., ::7].shape)
                d_np = (d_np & 0xFFFF).astype(np.int32)
                d = torch.from_numpy(d_np).to(dev)
                default = _default_prediction(16, pt)
                got = lossless_recur(d, predictor, pt, default)
                plain = lossless_recur_plain(d, predictor, pt, default)
                torch.cuda.synchronize()
                err = int((got - plain).abs().max())
                oracle_ok = shape == L1_FULL or all(   # the oracle is a
                    np.array_equal(got[c].cpu().numpy(),   # Python loop
                                   reconstruct_lossless(
                                       d_np[c], Predictor(predictor), pt, 16,
                                       False))
                    for c in range(shape[0]))
                if err or not oracle_ok:
                    raise AssertionError(
                        f"L1 {shape} predictor {predictor} pt {pt}: vs plain "
                        f"{err}, oracle equal: {oracle_ok}")
                l1_err = max(l1_err, err)
                l1_cases += 1

    t0 = time.perf_counter()
    samples = sof3_samples(SOF3_SIDE, SOF3_SIDE, 1, 16, 0, seed=0)
    streams = {p: sof3_jpeg(samples, p, 0, 16) for p in (1, 6)}
    write_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    jt.reset_launches()
    with jt.DeviceStreamDecoder(device="cuda", host_threads=2) as dec:
        images = dec.decode_stream(list(streams.values()))
        torch.cuda.synchronize()
        launches = dict(jt.LAUNCHES)
        for (p, blob), img in zip(streams.items(), images):
            if img.dtype != torch.uint16 or max_diff(
                    img, host_exact(blob), f"predictor {p}") \
                    or not np.array_equal(img.cpu().numpy(), samples):
                raise AssertionError(f"SOF3 predictor {p} differs")
        rates = {p: dec.device_resident_rate(blob, iters=10)
                 for p, blob in streams.items()}
    if launches["lossless_recur"] < 1:
        raise AssertionError(f"L1 never ran: {launches}")
    rgb = sof3_samples(*SOF3_RGB, 3, 16, 0, seed=1)
    rgb_blob = sof3_jpeg(rgb, 6, 0, 16)
    with jt.DeviceStreamDecoder(device="cuda", host_threads=1) as dec:
        staged_rgb = dec.stage(rgb_blob)
        wires = dec._to_device(staged_rgb)
        torch.cuda.synchronize()
        jt.reset_launches()
        img = dec._run_device(staged_rgb, wires)
        torch.cuda.synchronize()
        rgb_launches = jt.LAUNCHES["lossless_recur"]
        if rgb_launches != 1 or img.dtype != torch.uint16 \
                or not np.array_equal(img.cpu().numpy(), rgb):
            raise AssertionError(f"3-component SOF3: {rgb_launches} L1 "
                                 "launches (want 1), or the samples differ")
        rgb_rate = dec.device_resident_rate(rgb_blob, iters=10)
    staged = jt.stage_host_bits(streams[6])
    d = (torch.from_numpy(staged.diffs.view(np.int16)).to(dev)
         .to(torch.int32) & 0xFFFF)
    default = _default_prediction(16, 0)
    full = lossless_recur(d, 6, 0, default)
    full_plain = lossless_recur_plain(d, 6, 0, default)
    torch.cuda.synchronize()
    err = int((full - full_plain).abs().max())
    if err:
        raise AssertionError(f"L1 at full size differs from plain: {err}")
    l1_ms = cuda_ms(lambda: lossless_recur(d, 6, 0, default), 10)
    l1_plain_ms = cuda_ms(lambda: lossless_recur_plain(d, 6, 0, default), 1)
    d3 = d.expand(3, -1, -1).contiguous()
    l1_3_ms = cuda_ms(lambda: lossless_recur(d3, 6, 0, default), 10)
    chain = l1_chain_bound(*d.shape[1:])
    say("15 lossless", l1_cases=l1_cases,
        l1_shapes=[L1_PLANE, *L1_SHAPES, L1_FULL],
        l1_vs_plain_max_abs_err=l1_err,
        l1_vs_oracle=f"bit-equal (all but {L1_FULL})",
        rgb_stream={"shape": [*SOF3_RGB, 3], "l1_launches": rgb_launches,
                    "ms_per_image": rgb_rate["ms_per_image"],
                    "result": "bit-equal to the samples"},
        sof3_bytes={p: len(b) for p, b in streams.items()},
        sof3_write_seconds=write_s, launches=launches,
        result="bit-equal to the host decode",
        ms_per_image={p: r["ms_per_image"] for p, r in rates.items()},
        host_ms_per_image={p: r["host_ms_per_image"]
                           for p, r in rates.items()},
        l1_shape=list(d.shape), l1_ms=l1_ms, l1_plain_ms=l1_plain_ms,
        l1_3x2048x2048_ms=l1_3_ms, l1_chain=chain)
    return (launches["lossless_recur"], max(l1_err, err), l1_ms, l1_plain_ms,
            (lambda: lossless_recur(d, 6, 0, default)), d.numel(), chain)


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def batch_configs(data: dict) -> list:
    """17's configurations: (name, decoder options, stream, batch_size,
    launches the batched run must make, by kernel)."""
    from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

    tower, large = data["tower_420.jpg"], data["large_420.jpg"]
    mixed = [(FIXTURES / n).read_bytes() for n in MIXED]
    sof3 = {p: [sof3_jpeg(sof3_samples(*SOF3_SLICE, 1, 16, 0, seed=s), p, 0,
                          16) for s in range(8)] for p in (1, 6)}
    return [
        ("tower_420 x32 at 16", {}, [tower] * 32, 16,
         {"huffman_decode": 2, "dequant_idct": 2, "idct_exact": 0,
          "interleaved_tail": 2, "prefix_rebuild": 0}),
        ("large_420 x4 at 4", {}, [large] * 4, 4,
         {"huffman_decode": 1, "dequant_idct": 1, "idct_exact": 0,
          "interleaved_tail": 1}),
        # One hetero group: one sweep, one reconstruction per plan.
        ("mixed sizes x8 at 8", {}, mixed + mixed[:2], 8,
         {"huffman_decode": 1, "dequant_idct": len(MIXED),
          "interleaved_tail": len(MIXED)}),
        ("mixed sizes x8 at 8 exact", {"precision": "exact"},
         mixed + mixed[:2], 8,
         {"huffman_decode": 1, "dequant_idct": 0, "idct_exact": len(MIXED),
          "interleaved_tail": len(MIXED)}),
        ("tower_420 x8 at 8 exact", {"precision": "exact"}, [tower] * 8, 8,
         {"huffman_decode": 1, "dequant_idct": 0, "idct_exact": 1,
          "interleaved_tail": 1}),
        ("tower_420 x8 at 8 prefix", {"interchange": "prefix"}, [tower] * 8,
         8, {"huffman_decode": 0, "dequant_idct": 1, "idct_exact": 0,
             "interleaved_tail": 1, "prefix_rebuild": 2}),
        ("tower_420 x8 at 8 prefix exact",
         {"interchange": "prefix", "precision": "exact"}, [tower] * 8, 8,
         {"huffman_decode": 0, "dequant_idct": 0, "idct_exact": 1,
          "interleaved_tail": 1, "prefix_rebuild": 2}),
        ("tower_420 x8 at 8 planar-pallas", {"layout": "planar-pallas"},
         [tower] * 8, 8,
         {"huffman_decode": 1, "dequant_idct": 1, "fused_tail": 1,
          "interleaved_tail": 0}),
        ("SOF3 512x512 16-bit x8 at 8 predictor 1", {}, sof3[1], 8,
         {"lossless_recur": 0, "interleaved_tail": 0}),
        ("SOF3 512x512 16-bit x8 at 8 predictor 6", {}, sof3[6], 8,
         {"lossless_recur": 1, "interleaved_tail": 0}),
    ]


def phase_batch(jt, data: dict, params, dev, profile_layers) -> dict:
    """17. Batched dispatch through decode_stream(batch_size=N)."""
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import (decode_chunks,
                                                             unpack_delta)
    from jpeg_decoder_tpu_torch.models.stream import merge_scans
    from jpeg_decoder_tpu_torch.ops.kernels import (dequant_idct_batch,
                                                    dequant_idct_multi,
                                                    fused_tail,
                                                    idct_exact_batch,
                                                    interleaved_tail)
    from jpeg_decoder_tpu_torch.ops.predictors import lossless_recur
    from tools.torch_port_profile import kernel_device_us
    from torch_inputs import t1_args, t1_geometry

    results = {}
    for name, kw, stream, batch_size, want in batch_configs(data):
        with jt.DeviceStreamDecoder(device="cuda", host_threads=4,
                                    **kw) as dec:
            single = dec.decode_stream(stream)
            torch.cuda.synchronize()
            jt.reset_launches()
            t0 = time.perf_counter()
            batched = dec.decode_stream(stream, batch_size=batch_size)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(jt.LAUNCHES)
        for i, (a, b) in enumerate(zip(batched, single)):
            if not (a.is_cuda and a.shape == b.shape and torch.equal(a, b)):
                raise AssertionError(f"17 {name}: image {i} differs from "
                                     "its batch_size=1 decode")
        wrong = {k: (launches[k], v) for k, v in want.items()
                 if launches[k] != v}
        if wrong or len(batched) != len(stream):
            raise AssertionError(f"17 {name}: launches (got, want) {wrong}")
        results[name] = {"images": len(stream), "batch_size": batch_size,
                         "launches": launches, "wall_ms": wall * 1e3}
    say("17 batches", result="bit-equal to batch_size=1", **results)

    good = data["tower_420.jpg"]
    with jt.DeviceStreamDecoder(device="cuda", host_threads=4) as dec:
        outs = dec.decode_stream([good, BAD_JPEG, good, good], batch_size=4,
                                 on_error="none")
        single = dec.decode_stream([good])[0]
    if [o is None for o in outs] != [False, True, False, False] or not all(
            torch.equal(o, single) for o in (outs[0], outs[2], outs[3])):
        raise AssertionError("17 on_error inside a batch")

    # Batched K2 and K3 against per-image launches, by SHA-256, at
    # tower_420's shapes x 16: per-image tables (48 segments) and one
    # encoder's tables (3 merged segments).
    rng = np.random.default_rng(17)
    blocks = (4096, 1024, 1024)
    coefs = [torch.from_numpy(rng.integers(-1024, 1024, (16, b, 64))
                              .astype(np.int16)).to(dev) for b in blocks]
    digests = {}
    for tables_of in ("per image", "shared"):
        tabs = [[rng.integers(1, 60, 64).astype(np.uint16) for _ in blocks]
                for _ in range(16)]
        if tables_of == "shared":
            tabs = [tabs[0]] * 16
        qs = [[params.qt(t[c]) for t in tabs] for c in range(3)]
        folded = [[params.folded(t[c], 8) for t in tabs] for c in range(3)]
        bases = [params.basis(8)] * 3
        got = dequant_idct_batch(coefs, qs, bases, [8] * 3, folded)
        alone = [dequant_idct_multi([c[i] for c in coefs],
                                    [q[i] for q in qs], bases, [8] * 3,
                                    [f[i] for f in folded])
                 for i in range(16)]
        digests[f"k2 {tables_of}"] = (
            _digest(g[i] for i in range(16) for g in got),
            _digest(a for img in alone for a in img))
    planes = [torch.from_numpy(rng.integers(0, 256, (16, h, w))
                               .astype(np.uint8)).to(dev)
              for h, w in ((512, 512), (256, 256), (256, 256))]
    k3_args = (("h1v1", "h2v2", "h2v2"), (256, 256), "ycbcr", 512, 512)
    k3_batched = fused_tail(planes, *k3_args)
    digests["k3"] = (_digest([k3_batched]), _digest(
        fused_tail([p[i] for p in planes], *k3_args) for i in range(16)))
    torch.cuda.synchronize()
    if any(a != b for a, b in digests.values()):
        raise AssertionError(f"17 batched K2/K3 bits differ: {digests}")

    # Times: device-resident ms/image and launches/image (profiler).
    rates = {}
    for name, batch, precision in (
            ("tower_420.jpg", 1, "fast"), ("tower_420.jpg", 4, "fast"),
            ("tower_420.jpg", 16, "fast"), ("large_420.jpg", 4, "fast"),
            ("tower_420.jpg", 1, "exact"), ("tower_420.jpg", 16, "exact")):
        with jt.DeviceStreamDecoder(device="cuda", host_threads=4,
                                    precision=precision) as dec:
            rate = dec.device_resident_rate(data[name], iters=20,
                                            batch=batch)
            prof, _trace = profile_layers(dec, FIXTURES / name, 10, batch)
        rates[f"{name} batch {batch} {precision}"] = {
            "ms_per_image": rate["ms_per_image"], "batch": rate["batch"],
            "host_ms_per_image": rate["host_ms_per_image"],
            "launches_per_image": prof["launches_per_image"],
            "device_busy_ms_per_image": prof["device_busy_ms"],
            "idle_share": prof["idle_share"]}

    # Kernel times at the batched shapes, beside their bounds.
    tower_scan = jt.stage_host_bits(data["tower_420.jpg"]).scans[0]
    (words, dm), s_max, n_blocks = merge_scans([tower_scan] * 16)
    words, dm = torch.from_numpy(words).to(dev), torch.from_numpy(dm).to(dev)
    ab, base = unpack_delta(dm)
    k1_args = (words, dm, ab, base, params.tables(tower_scan.scan), s_max,
               n_blocks)
    shared_q = [[q[0]] * 16 for q in qs]
    shared_f = [[f[0]] * 16 for f in folded]
    shared_e1 = [[params.qt_exact(tabs[0][c])] * 16 for c in range(3)]
    sof3_slices = torch.from_numpy(rng.integers(0, 65536, (8, *SOF3_SLICE))
                                   .astype(np.int32)).to(dev)
    t1_tower = t1_args(t1_geometry("420", 512, 512, 8, "YCBCR"))
    t1_pixels = [c.view(16, -1, 8, 8).to(torch.uint8) for c in coefs]
    kernels = {
        "K1 tower_420 x16 merged wire": (
            lambda: decode_chunks(*k1_args), "huffman_decode_kernel",
            4 * sum(a.numel() for a in k1_args[:4]) + 128 * n_blocks),
        "K2 tower_420 x16, one table set": (
            lambda: dequant_idct_batch(coefs, shared_q, bases, [8] * 3,
                                       shared_f),
            "dequant_idct_kernel", 16 * sum(blocks) * (128 + 64)),
        "E1 tower_420 x16, one table set": (
            lambda: idct_exact_batch(coefs, shared_e1, [8] * 3),
            "idct_exact_kernel", 16 * sum(blocks) * (128 + 64)),
        "K3 tower_420 planes x16": (
            lambda: fused_tail(planes, *k3_args), "fused_tail_kernel",
            sum(p.numel() for p in planes) + 16 * 3 * 512 * 512),
        "T1 tower_420 x16": (
            lambda: interleaved_tail(t1_pixels, *t1_tower),
            "interleaved_tail_kernel",
            sum(p.numel() for p in t1_pixels) + 16 * 3 * 512 * 512),
        "L1 8 x 512 x 512 predictor 6": (
            lambda: lossless_recur(sof3_slices, 6, 0, 1 << 15),
            "lossless_recur_kernel", 8 * sof3_slices.numel()),
    }
    times = {}
    for name, (fn, symbol, nbytes) in kernels.items():
        prof = kernel_device_us(fn, symbol)
        times[name] = {"kernel_us": prof["kernel_us"],
                       "launches": prof["launches"],
                       "bytes_bound_us": nbytes / HBM_BPS * 1e6}
    say("17 batch times", device_resident=rates, kernels=times,
        digests={k: v[0][:16] for k, v in digests.items()},
        digests_equal=True, on_error_none=["cuda tensor", None,
                                           "cuda tensor", "cuda tensor"])
    return results


def _split_ms(decode, reps: int = 5) -> dict:
    """Median ms per decode of `decode(timer)` over `reps` runs after a
    warm-up: the wall time (host clock, the result on the host) and its
    split by the timer's stages; host entropy is the rest."""
    decode(jt_timer())
    rows = []
    for _ in range(reps):
        timer = jt_timer()
        t0 = time.perf_counter()
        decode(timer)
        wall = (time.perf_counter() - t0) * 1e3
        stages = {k: v * 1e3 for k, v in timer.totals.items()}
        rows.append({"wall_ms": wall, **stages,
                     "host_entropy_ms": wall - sum(stages.values())})
    return {k: float(np.median([r.get(k, 0.0) for r in rows]))
            for k in rows[0]}


def jt_timer():
    from jpeg_decoder_tpu_torch.utils.timing import StageTimer

    return StageTimer()


def phase_front_end(jt, data: dict, dev) -> dict:
    """18. The front end (`Decoder`) and the service on the card; returns
    the launches of K2, E1 and L1 it counted."""
    from jpeg_decoder_tpu_torch.decoder import device_params
    from jpeg_decoder_tpu_torch.host.decoder import Decoder as HostDecoder
    from jpeg_decoder_tpu_torch.host.ops.pipeline import geometry_from_frame
    from jpeg_decoder_tpu_torch.ops.pipeline import reconstruct
    from jpeg_decoder_tpu_torch.transfer import pinned_pool, put
    from jpeg_decoder_tpu_torch.utils import link
    from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

    def host(blob, precision="exact", scale_to=None):
        d = HostDecoder(blob, precision=precision)
        if scale_to is not None:
            d.scale(*scale_to)
        return d.decode()

    def port(blob, precision="exact", scale_to=None, backend="torch"):
        d = jt.Decoder(blob, backend=backend, precision=precision)
        if scale_to is not None:
            d.scale(*scale_to)
        return d.decode()

    def worst(a: bytes, b: bytes) -> int:
        if len(a) != len(b):
            raise AssertionError(f"{len(a)} bytes vs {len(b)}")
        return int(np.abs(np.frombuffer(a, np.uint8).astype(np.int16)
                          - np.frombuffer(b, np.uint8)).max())

    names = ORDER + ("small_422_progressive.jpg",)
    blobs = {n: data.get(n) or (FIXTURES / n).read_bytes() for n in names}
    cases = [(n, blobs[n], None) for n in names] + [
        (f"large_420 {s}", blobs["large_420.jpg"], s) for s in FRONT_SCALES]
    counted = {}
    fast_err = {}
    exact_out = {}
    for precision in ("exact", "fast"):
        torch.cuda.synchronize()
        jt.reset_launches()
        for name, blob, size in cases:
            got = port(blob, precision, size)
            want = host(blob, "exact", size)
            if precision == "exact":
                exact_out[name] = got
                if got != want:
                    raise AssertionError(f"18 Decoder exact {name} differs "
                                         "from the host decode")
            else:
                fast_err[name] = worst(got, want)
                if fast_err[name] > PIXEL_TOL:
                    raise AssertionError(f"18 Decoder fast {name}: max |diff| "
                                         f"{fast_err[name]} > {PIXEL_TOL}")
        torch.cuda.synchronize()
        counted[precision] = dict(jt.LAUNCHES)
    if counted["fast"]["dequant_idct"] < len(cases) \
            or counted["exact"]["idct_exact"] != len(cases) \
            or counted["exact"]["interleaved_tail"] != len(cases) \
            or counted["fast"]["interleaved_tail"] < len(cases) \
            or counted["exact"]["dequant_idct"] or counted["fast"]["idct_exact"]:
        raise AssertionError(f"18 K2 once per image at fast, E1 at exact: "
                             f"{counted}")

    # Lossless through the Decoder: L1 once per component at predictor 6.
    sof3 = sof3_samples(SOF3_SIDE, SOF3_SIDE, 1, 16, 0, seed=0)
    rgb = sof3_samples(*SOF3_RGB, 3, 16, 0, seed=1)
    ll_cases = {"2048x2048 p1": (sof3_jpeg(sof3, 1, 0, 16), 1, 0),
                "2048x2048 p6": (sof3_jpeg(sof3, 6, 0, 16), 1, 1),
                "768x1024x3 p6": (sof3_jpeg(rgb, 6, 0, 16), 3, 3)}
    ll_launches = {}
    for name, (blob, _ncomp, want_l1) in ll_cases.items():
        torch.cuda.synchronize()
        jt.reset_launches()
        got = port(blob)
        torch.cuda.synchronize()
        ll_launches[name] = jt.LAUNCHES["lossless_recur"]
        if got != host(blob) or ll_launches[name] != want_l1:
            raise AssertionError(f"18 SOF3 {name}: L1 launches "
                                 f"{ll_launches[name]} (want {want_l1}), or "
                                 "the samples differ from the host decode")

    # "auto": the host at or below 128 x 128, the card above.
    auto = {}
    small_ll = sof3_jpeg(sof3_samples(96, 96, 1, 16, 0, seed=2), 6, 0, 16)
    for name, blob, size, precision in (
            ("small_gray 1/8", blobs["small_gray.jpg"], (22, 15), "fast"),
            ("SOF3 96x96 p6", small_ll, None, "exact"),
            ("tower_420", blobs["tower_420.jpg"], None, "fast")):
        torch.cuda.synchronize()
        jt.reset_launches()
        got = port(blob, precision, size, backend="auto")
        torch.cuda.synchronize()
        auto[name] = sum(jt.LAUNCHES.values())
        if worst(got, host(blob, "exact", size)) > PIXEL_TOL:
            raise AssertionError(f"18 auto {name} differs from the host")
    if auto["small_gray 1/8"] or auto["SOF3 96x96 p6"] \
            or jt.LAUNCHES["dequant_idct"] < 1:
        raise AssertionError(f"18 auto launches: {auto}")

    # The service against the per-image Decoder: E1 once per image.
    torch.cuda.synchronize()
    jt.reset_launches()
    service = jt.BatchDecodeService().decode_all([blobs[n] for n in names])
    service_launches = dict(jt.LAUNCHES)
    if service_launches["idct_exact"] != len(names) \
            or service_launches["interleaved_tail"] != len(names):
        raise AssertionError(f"18 service launches: {service_launches}")
    for name, img in zip(names, service):
        if img.tobytes() != exact_out[name]:
            raise AssertionError(f"18 service {name} differs from Decoder")

    # The stream with a timer: twice, and once without, SHA-256-equal.
    pool = pinned_pool(dev)
    streams = {"tower_420 x64 at 16": ([blobs["tower_420.jpg"]] * 64, 16),
               "large_420 x4 at 4": ([blobs["large_420.jpg"]] * 4, 4)}
    stream_rows = {}
    for name, (stream, batch) in streams.items():
        digests = []
        for timed in (True, True, False):
            timer = jt_timer() if timed else None
            copy_s, copied = pool.copy_seconds, pool.copied_bytes
            with jt.DeviceStreamDecoder(host_threads=4, timer=timer) as dec:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = dec.decode_stream(stream, batch_size=batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            h2d_bytes = pool.copied_bytes - copied
            digests.append([_digest([img]) for img in out])
            if timed:
                counts = dict(timer.counts)
                if min(counts.get(k, 0) for k in (
                        "host_stage", "h2d_submit", "device_dispatch")) < 1:
                    raise AssertionError(f"18 stages not counted: {counts}")
                h2d_s = timer.totals["h2d_submit"]
                stream_rows[name] = {
                    "ms_per_image": wall * 1e3 / len(stream),
                    "stage_ms_per_image": {
                        k: v * 1e3 / len(stream)
                        for k, v in timer.totals.items()},
                    "stage_counts": counts,
                    "h2d_bytes_per_image": h2d_bytes / len(stream),
                    "h2d_submit_bytes_per_s": h2d_bytes / h2d_s,
                    "pinned_copy_ms_per_image":
                        (pool.copy_seconds - copy_s) * 1e3 / len(stream)}
        if any(d != digests[0] for d in digests[1:]):
            raise AssertionError(f"18 {name}: images differ between runs")
        stream_rows[name]["first_image_sha256"] = digests[0][0][:16]

    # Times of Decoder.decode, split by stage, beside the host backend.
    decode_rows = {}
    for name in RATE_FIXTURES:
        blob = blobs[name]
        for backend, precision in (("torch", "exact"), ("torch", "fast"),
                                   ("numpy", "exact")):
            row = _split_ms(lambda t: jt.Decoder(
                blob, backend=backend, precision=precision,
                timer=t).decode())
            if backend == "torch":
                d = HostDecoder(blob, precision=precision)
                d._decode_entropy_only()
                n = len(d.frame.components)
                geometry = geometry_from_frame(
                    d.frame, None if n == 1 else
                    d._determine_color_transform(), precision=precision)
                stores = put([d._pending_render[i][0].reshape(1, -1, 64)
                              for i in range(n)], dev)
                qts = [tuple(d._pending_render[i][1] for i in range(n))]
                params = device_params(dev)
                row["reconstruct_device_ms"] = cuda_ms(
                    lambda: reconstruct(geometry, stores, qts, params), 10)
            decode_rows[f"{name} {backend} {precision}"] = row

    # H2D: pinned (through the pool) against pageable, by CUDA events.
    h2d = {}
    for size in H2D_SIZES:
        a = np.random.default_rng(size).integers(0, 255, size, np.uint8)
        locked = torch.from_numpy(a).pin_memory()
        pinned = cuda_ms(lambda: put((a,), dev), 20)
        dma = cuda_ms(lambda: locked.to(dev, non_blocking=True), 20)
        pageable = cuda_ms(lambda: torch.from_numpy(a).to(dev), 20)
        h2d[size] = {"put_ms": pinned, "pinned_dma_ms": dma,
                     "pageable_ms": pageable,
                     "put_gb_s": size / pinned / 1e6,
                     "pinned_dma_gb_s": size / dma / 1e6,
                     "pageable_gb_s": size / pageable / 1e6}
    probe_mb_s = link.probe()
    say("18 front end", exact="bit-equal to the host decode",
        images=len(cases), fast_max_abs_diff=fast_err, tolerance=PIXEL_TOL,
        launches=counted, lossless_l1_launches=ll_launches,
        auto_launches=auto, service="equal to Decoder",
        service_launches=service_launches)
    say("18 stream with a timer", result="SHA-256-equal across two timed "
        "runs and the untimed run", **stream_rows)
    say("18 times", decode_ms=decode_rows, h2d=h2d,
        link_probe_mb_s=probe_mb_s, link_degraded=link.degraded(),
        pinned_peak_bytes=pool.peak_bytes, pinned_bytes=pool.bytes)
    return {"K2": counted["fast"]["dequant_idct"],
            "E1": counted["exact"]["idct_exact"]
            + service_launches["idct_exact"],
            "T1": counted["fast"]["interleaved_tail"]
            + counted["exact"]["interleaved_tail"]
            + service_launches["interleaved_tail"],
            "L1": sum(ll_launches.values())}


MESH_SLOTS = 4          # 19: a mesh of this many slots
STRIPES = (4, 8)        # 19: large_420's stripe counts
# 19: the parent's launches per stripe of large_420 by stripe count, before
# D1 (PR 15's chip_smoke run, c15 in PERF.md), printed beside this run's.
PARENT_STRIPE_LAUNCHES = {4: 26.75, 8: 30.875}


def mesh_devices(n: int) -> list:
    """n mesh slots: the card's (cuda:0 n times on a machine with one),
    going round the cards where there are more."""
    return [f"cuda:{i % torch.cuda.device_count()}" for i in range(n)]


def eager_lines(mesh):
    """`mesh`, its first card's process-wide graph cache emptied
    (`graphs.device_graphs`): the next call of each of its lines is its
    key's first sight there, dispatched eagerly through the kernels'
    wrappers, which a phase's spies see."""
    from jpeg_decoder_tpu_torch.models import graphs

    graphs.device_graphs(mesh.first).clear()
    return mesh


def counted(jt, fn):
    """fn() with every launch count set to 0 just before and read just
    after: (its result, the counts)."""
    torch.cuda.synchronize()
    jt.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(jt.LAUNCHES)


def phase_mesh(jt, data: dict, params, dev, card: str) -> dict:
    """19. The mesh on slots of the card; returns K1's and E1's stripe
    launches and K1's largest difference from plain on the stripe
    wires."""
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import (
        decode_chunks, decode_chunks_plain)
    from jpeg_decoder_tpu_torch.models import graphs
    from jpeg_decoder_tpu_torch.parallel import make_mesh
    from jpeg_decoder_tpu_torch.parallel import mesh as mesh_mod
    from jpeg_decoder_tpu_torch.parallel.dryrun import dryrun_multichip
    from jpeg_decoder_tpu_torch.parallel.stripe_bits import (
        decode_bits_striped, decode_bits_striped_batch,
        split_anchored_stripes, stripe_wire)
    from tools.make_torch_fixtures import sof3_jpeg, sof3_samples
    from tools.torch_port_profile import kernel_device_us

    large, tower = data["large_420.jpg"], data["tower_420.jpg"]
    large_gold = host_exact(large)
    tower_gold = host_exact(tower)

    # K1 against its plain version on every stripe wire.
    k1_err, negative = 0, 0
    for name, n in (("large_420.jpg", 4), ("large_420.jpg", 8),
                    ("stripe_420.jpg", 8)):
        blob = data.get(name) or (FIXTURES / name).read_bytes()
        scan = jt.stage_host_bits(blob).scans[0].scan
        split = split_anchored_stripes(scan, n)
        for d in range(n):
            arrays, s_max = stripe_wire(split, d)
            args = tuple(torch.from_numpy(a).to(dev) for a in arrays) + (
                params.tables(scan), s_max, split.n_blocks_local)
            err = int((decode_chunks(*args).to(torch.int32)
                       - decode_chunks_plain(*args).to(torch.int32))
                      .abs().max())
            k1_err = max(k1_err, err)
            negative += int(len(arrays[3]) > 0 and arrays[3][0] < 0)
    torch.cuda.synchronize()
    if k1_err or negative < 4:
        raise AssertionError(f"19 K1 on the stripe wires: max |diff| "
                             f"{k1_err}, negative first blocks {negative}")

    # large_420 striped: bit-equal, one K1 launch per stripe.
    striped, stripe_launches, e1_stripe_launches, t1_stripe_launches, \
        a1_stripe_launches, d1_stripe_launches = {}, 0, 0, 0, 0, 0
    staged = jt.stage_host_bits(large)
    exact = jt.stage_host_bits(large, precision="exact")
    with jt.DeviceStreamDecoder(host_threads=1, precision="exact") as plain:
        exact_ms = cuda_ms(lambda: plain.decode_one(exact), 5)
        exact_prof = kernel_device_us(lambda: plain.decode_one(exact),
                                      "huffman_decode_kernel", iters=3)
    for n in STRIPES:
        mesh = make_mesh({"stripe": n}, mesh_devices(n))
        with jt.DeviceStreamDecoder(mesh=mesh, host_threads=1) as dec:
            mesh_mod.reset_exchanged()
            img, launches = counted(jt, lambda: dec.decode_striped(large))
            exchanged = dict(mesh_mod.EXCHANGED)
        if launches["huffman_decode"] != n or launches["dequant_idct"] \
                or launches["idct_exact"] != n \
                or launches["interleaved_tail"] != n \
                or launches["assemble"] != n or launches["unpack_delta"] \
                or launches["dc_totals"] != n:
            raise AssertionError(f"19 {n} stripes launched {launches}")
        if not np.array_equal(img.cpu().numpy(), large_gold):
            raise AssertionError(f"19 large_420 at {n} stripes differs from "
                                 "the host exact decode")
        stripe_launches += launches["huffman_decode"]
        e1_stripe_launches += launches["idct_exact"]
        t1_stripe_launches += launches["interleaved_tail"]
        a1_stripe_launches += launches["assemble"]
        d1_stripe_launches += launches["dc_totals"]
        # From the key's third call on, one replay of its stripes graph
        # a call; beside it the eager body on the same inputs.
        prof = kernel_device_us(lambda: decode_bits_striped(staged, mesh),
                                "huffman_decode_kernel", iters=3)
        ms = cuda_ms(lambda: decode_bits_striped(staged, mesh), 5)
        with eager_bodies():
            eager_prof = kernel_device_us(
                lambda: decode_bits_striped(staged, mesh),
                "huffman_decode_kernel", iters=3)
            eager_ms = cuda_ms(lambda: decode_bits_striped(staged, mesh), 5)
        striped[f"{n} stripes"] = {
            "ms_per_image": ms, "ms_per_stripe": ms / n,
            "eager_ms_per_image": eager_ms,
            "launches_per_image": prof["all_launches"],
            "launches_per_stripe": prof["all_launches"] / n,
            "eager_launches_per_stripe": eager_prof["all_launches"] / n,
            "graphs": graphs.device_graphs(mesh.first).stats(),
            "parent_launches_per_stripe_c15": PARENT_STRIPE_LAUNCHES[n],
            "k1_launches": launches["huffman_decode"],
            "e1_launches": launches["idct_exact"],
            "t1_launches": launches["interleaved_tail"],
            "a1_launches": launches["assemble"],
            "d1_launches": launches["dc_totals"],
            "device_busy_ms": prof["all_device_us"] / 1e3,
            "halo_bytes": exchanged["halo"], "carry_bytes":
            exchanged["carry"], "gather_bytes": exchanged["gather"]}
    striped["meshless exact"] = {
        "ms_per_image": exact_ms,
        "launches_per_image": exact_prof["all_launches"],
        "device_busy_ms": exact_prof["all_device_us"] / 1e3}
    say("19 striped large_420", card=card, result="bit-equal to the host "
        "exact decode", k1_vs_plain_on_stripe_wires=k1_err,
        stripe_wires_with_negative_first_block=negative, **striped)

    # Groups over {"data": 4}: every image SHA-256-equal to the meshless
    # decode, each kernel once per shard.
    sof3 = [sof3_jpeg(sof3_samples(*SOF3_SLICE, 1, 16, 0, seed=s), 6, 0, 16)
            for s in range(8)]
    data_mesh = make_mesh({"data": MESH_SLOTS}, mesh_devices(MESH_SLOTS))
    groups = {}
    for name, kw, stream, batch, want in (
            ("tower_420 x16 at 16", {}, [tower] * 16, 16,
             {"huffman_decode": 4, "dequant_idct": 4}),
            ("prefix tower_420 x8 at 8", {"interchange": "prefix"},
             [tower] * 8, 8, {"huffman_decode": 0, "dequant_idct": 4,
                              "prefix_rebuild": 8}),
            ("SOF3 512x512 16-bit x8 at 8 predictor 6", {}, sof3, 8,
             {"lossless_recur": 4})):
        with jt.DeviceStreamDecoder(host_threads=4, **kw) as plain:
            single = plain.decode_stream(stream)
        with jt.DeviceStreamDecoder(mesh=data_mesh, host_threads=4,
                                    **kw) as dec:
            out, launches = counted(
                jt, lambda: dec.decode_stream(stream, batch_size=batch))
        if [_digest([o]) for o in out] != [_digest([o]) for o in single]:
            raise AssertionError(f"19 {name}: an image differs from the "
                                 "meshless decode")
        wrong = {k: (launches[k], v) for k, v in want.items()
                 if launches[k] != v}
        if wrong:
            raise AssertionError(f"19 {name}: launches (got, want) {wrong}")
        groups[name] = {"images": len(stream), "launches": launches}

    # Each DP shard's device ms: tower_420 x 4 per shard, wire on the card.
    with jt.DeviceStreamDecoder(mesh=data_mesh, host_threads=1) as dec:
        shard = [dec.stage(tower) for _ in range(4)]
        shard_ms = []
        for sdev in data_mesh.axis_devices("data"):
            wires = dec._group_halves(shard, *dec._bits_merge(shard), sdev,
                                      None)
            shard_ms.append(cuda_ms(
                lambda: dec._run_group("bits", shard, wires), 20))

    # DP x SP on the bits path.
    pair_mesh = make_mesh({"data": 2, "stripe": 2}, mesh_devices(4))
    out, launches = counted(jt, lambda: decode_bits_striped_batch(
        [jt.stage_host_bits(tower) for _ in range(4)], pair_mesh))
    # K1 per image and stripe; E1 per (data shard, stripe), 2 images each.
    if out is None or launches["huffman_decode"] != 8 \
            or launches["idct_exact"] != 4 \
            or launches["interleaved_tail"] != 4 or not all(
                np.array_equal(o.cpu().numpy(), tower_gold) for o in out):
        raise AssertionError(f"19 DP x SP bits batch: {launches}")

    # The service with a mesh, against the meshless service.
    blobs = [data[n] for n in ORDER] + [tower] * 3
    meshless = jt.BatchDecodeService().decode_all(blobs)
    (served, service_launches) = counted(
        jt, lambda: jt.BatchDecodeService(data_mesh).decode_all(blobs))
    if any(a.tobytes() != b.tobytes() for a, b in zip(served, meshless)) \
            or service_launches["idct_exact"] != len(blobs) \
            or service_launches["interleaved_tail"] != len(blobs):
        raise AssertionError(f"19 the service on a mesh differs, or E1 or "
                             f"T1 not once per image: {service_launches}")

    ran = dryrun_multichip(MESH_SLOTS, ["cuda:0"] * MESH_SLOTS)
    say("19 mesh", card=card, groups=groups, result="SHA-256-equal to the "
        "meshless decode", dp_shard_device_ms_tower_420_x4=shard_ms,
        dp_x_sp_bits={"images": 4, "launches": launches},
        service={"images": len(blobs), "launches": service_launches},
        dryrun=ran, cards=torch.cuda.device_count())
    return {"stripe_launches": stripe_launches,
            "e1_stripe_launches": e1_stripe_launches,
            "t1_stripe_launches": t1_stripe_launches,
            "a1_stripe_launches": a1_stripe_launches,
            "d1_stripe_launches": d1_stripe_launches, "k1_err": k1_err,
            "launches_per_stripe": {n: striped[f"{n} stripes"][
                "launches_per_stripe"] for n in STRIPES},
            "striped_8_ms": striped["8 stripes"]["ms_per_image"]}


MULTIPROC_TIMEOUT = 480     # 20: seconds for the two-process harness
MULTIPROC_MARK = "MULTIPROC-MESH-TORCH OK"


def phase_multiproc(jt, card: str, one_process_ms: float) -> dict:
    """20. The mesh across two processes on the card. Returns each rank's
    launches per kernel over the harness's phases."""
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "multiproc_mesh_torch.py"),
         "--device", "cuda", "--timeout", str(MULTIPROC_TIMEOUT)],
        cwd=ROOT, capture_output=True, text=True,
        timeout=MULTIPROC_TIMEOUT + 60)
    if res.returncode != 0 or res.stdout.count(MULTIPROC_MARK) != 2:
        raise AssertionError(f"20 the two-process harness failed (exit "
                             f"{res.returncode}):\n{res.stdout[-4000:]}\n"
                             f"{res.stderr[-2000:]}")
    reports = {}
    for line in res.stdout.splitlines():
        if line.startswith('{"rank"'):
            rep = json.loads(line)
            reports[rep["rank"]] = rep
    if sorted(reports) != [0, 1]:
        raise AssertionError(f"20 rank reports {sorted(reports)}")
    per_rank = {}
    for rank, rep in sorted(reports.items()):
        phases = rep["phases"]
        want = {  # phase -> launches each rank must count
            "3 bits": {"huffman_decode": phases["3 bits"]["local_shards"],
                       "dequant_idct":
                       sum(phases["3 bits"]["plans_per_shard"])},
            "4 lossless": {"lossless_recur": 4},
            "3 prefix": {"prefix_rebuild":
                         2 * phases["3 prefix"]["local_shards"]},
            "5 large_420": {"huffman_decode": 4, "dequant_idct": 0,
                            "dc_totals": 4},
            "5 stripe_420": {"huffman_decode": 4, "dequant_idct": 0,
                             "dc_totals": 4}}
        wrong = {name: {k: (phases[name]["launches"][k], v)
                        for k, v in counts.items()
                        if phases[name]["launches"][k] != v}
                 for name, counts in want.items()}
        wrong = {k: v for k, v in wrong.items() if v}
        unequal = [name for name, rec in phases.items()
                   if rec.get("equal") is not True]
        k1_err = max(phases[f"5 {n}"]["k1_vs_plain_on_own_stripe_wires"]
                     for n in ("large_420", "stripe_420"))
        crossed = {name: rec["crossed"] for name, rec in phases.items()}
        quiet = [name for name in ("1 dp", "3 prefix", "3 bits",
                                   "4 lossless") if any(crossed[name].values())]
        seamless = [name for name in ("2 sp", "5 large_420", "5 stripe_420")
                    if not crossed[name]["halo"]]
        if wrong or unequal or k1_err or quiet or seamless or (
                rank == 1 and not crossed["5 large_420"]["carry"]):
            raise AssertionError(
                f"20 rank {rank}: launches (got, want) {wrong}, not equal "
                f"{unequal}, K1 vs plain {k1_err}, crossed {crossed}")
        per_rank[rank] = {k: sum(rec["launches"][k] for rec in phases.values())
                          for k in jt.LAUNCHES}
        say(f"20 rank {rank}", card=card, device=rep["device"],
            slots=rep["local_slots"],
            verdicts={name: "bit-equal" for name in phases},
            launches={name: {k: rec["launches"][k] for k in
                             ("huffman_decode", "dequant_idct",
                              "lossless_recur", "idct_exact")}
                      for name, rec in phases.items()},
            k1_vs_plain_on_own_stripe_wires=k1_err,
            own_wires_with_negative_first_block={
                n: phases[f"5 {n}"]["own_wires_with_negative_first_block"]
                for n in ("large_420", "stripe_420")},
            crossed_bytes=crossed,
            exchanged_bytes={name: rec["exchanged"]
                             for name, rec in phases.items()},
            staged_rows={name: rec["staged_rows"] for name, rec in
                         phases.items() if "staged_rows" in rec},
            phase_ms={name: rec["ms"] for name, rec in phases.items()},
            striped_large_420_cuda_event_ms=phases["5 large_420"][
                "cuda_event_ms_per_image"],
            one_process_19_striped_8_ms=one_process_ms)
    return per_rank


FUZZ_SOURCES = 300          # 21: device-mode sources on the card
FUZZ_SEED = 11
SANITIZED_SOURCES = 50      # 21: more under compute-sanitizer, where it is
SWEEP_SLOTS = (1, 2, 4)     # 22: slots of cuda:0 in the scaling sweep
OUT = ROOT / "chiprun_out"


def phase_fuzz(jt, card: str) -> dict:
    """21. The mutation fuzzer's device mode on the card
    (`tools/fuzz_torch.py::run_device`); returns its counts."""
    from tools import fuzz_torch

    t0 = time.perf_counter()
    res = fuzz_torch.run_device(FUZZ_SOURCES, FUZZ_SEED,
                                out=str(OUT / "fuzz_torch"), device="cuda")
    seconds = time.perf_counter() - t0
    launches = res["launches"]
    missing = [k for k in ("huffman_decode", "dequant_idct", "fused_tail",
                           "lossless_recur", "idct_exact", "interleaved_tail",
                           "assemble", "unpack_delta")
               if launches[k] < 1]
    if res["failures"] or missing \
            or res["k1_vs_plain_checked"] != res["k1_scans_checked"] \
            or not (res["k3_checked_on_mutants"]
                    and res["l1_checked_on_mutants"]):
        raise AssertionError(f"21 the device fuzz: {res}; kernels never "
                             f"launched {missing}")
    say("21 fuzz", card=card, sources=res["sources"],
        mutants=res["mutants"], accepted=res["accepted"],
        fallbacks=res["fallbacks"], lossless=res["lossless"],
        typed_errors=res["typed_errors"], failures=res["failures"],
        fast_misses=res["fast_misses"],
        fast_miss_max_dequantized=res["fast_miss_max_dequantized"],
        k1_scans_vs_oracle_and_plain=res["k1_vs_plain_checked"],
        k3_vs_plain=res["k3_checked"],
        k3_vs_plain_on_mutants=res["k3_checked_on_mutants"],
        l1_vs_plain=res["l1_checked"],
        l1_vs_plain_on_mutants=res["l1_checked_on_mutants"],
        decoder_checked=res["decoder_checked"],
        launches={"K1": launches["huffman_decode"],
                  "K2": launches["dequant_idct"],
                  "K3": launches["fused_tail"],
                  "L1": launches["lossless_recur"],
                  "E1": launches["idct_exact"],
                  "T1": launches["interleaved_tail"],
                  "A1": launches["assemble"],
                  "U1": launches["unpack_delta"]},
        seconds=seconds)
    sanitizer = shutil.which("compute-sanitizer")
    if sanitizer is None:
        say("21 compute-sanitizer", result="absent: not on PATH, the "
            "memcheck leg did not run")
        return res
    # A control first: one PyTorch allocation on the card under memcheck.
    # Where the tool cannot run a CUDA program at all (it reports errors on
    # the control), its reports on the fuzz would say nothing of the port.
    control = memcheck(sanitizer, ["-c", "import torch; "
                                   "torch.ones(4, device='cuda').sum()"])
    if not control["clean"]:
        say("21 compute-sanitizer", path=sanitizer, result="present but "
            "unusable on this machine: memcheck reports errors on the "
            "control (one torch.ones on the card), so the fuzz leg did not "
            "run", control=control)
        return res
    t0 = time.perf_counter()
    run = memcheck(sanitizer, [str(ROOT / "tools" / "fuzz_torch.py"),
                               str(SANITIZED_SOURCES), str(FUZZ_SEED + 1),
                               "--device", "--out",
                               str(OUT / "fuzz_torch_memcheck")])
    if not run["clean"]:
        raise AssertionError(f"21 compute-sanitizer memcheck on the fuzz: "
                             f"{run}")
    say("21 compute-sanitizer", path=sanitizer, sources=SANITIZED_SOURCES,
        control=control["summary"], summary=run["summary"],
        seconds=time.perf_counter() - t0)
    return res


def memcheck(sanitizer: str, args: list) -> dict:
    """`python args` under compute-sanitizer's memcheck: its exit code,
    its ERROR SUMMARY line, its first reports, and whether it is clean
    (exit 0 and 0 errors)."""
    run = subprocess.run([sanitizer, "--tool", "memcheck", sys.executable,
                          *args], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    lines = run.stdout.splitlines()
    summary = next((line for line in reversed(lines)
                    if "ERROR SUMMARY" in line), None)
    reports = [line for line in lines if line.startswith("========= ")
               and "Host Frame" not in line][:8]
    return {"exit": run.returncode, "summary": summary, "reports": reports,
            "clean": run.returncode == 0 and summary is not None
            and "ERROR SUMMARY: 0 errors" in summary}


def phase_tools(jt, card: str) -> dict:
    """22. The scaling sweep on slots of the card, and the jpg -> png CLI,
    each PNG against the host decode. Returns the sweep's rows."""
    from examples.decode_torch import main as cli
    from examples.decode_torch import read_png, viewable
    from jpeg_decoder_tpu_torch.host.decoder import Decoder
    from tools import scaling_bench_torch
    from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

    rows = scaling_bench_torch.sweep((FIXTURES / "large_420.jpg")
                                     .read_bytes(), SWEEP_SLOTS, "cuda",
                                     log=lambda line: None)
    if not all(r.get("equal") for r in rows):
        raise AssertionError(f"22 a sweep output differs: {rows}")
    for row in rows:
        say("22 sweep", card=card, **row)
    OUT.mkdir(exist_ok=True)
    sof3 = OUT / "sof3_p6_16.jpg"
    sof3.write_bytes(sof3_jpeg(sof3_samples(512, 512, 1, 16, 0, seed=4), 6,
                               0, 16))
    cases = ((FIXTURES / "tower_420.jpg", "exact", "dequant_idct", 0),
             (FIXTURES / "tower_420.jpg", "fast", "dequant_idct", PIXEL_TOL),
             (sof3, "exact", "lossless_recur", 0))
    done = {}
    for src, precision, kernel, tol in cases:
        png = OUT / f"{src.stem}_{precision}.png"
        (_, launches) = counted(jt, lambda: cli(
            [str(src), str(png), "--precision", precision]))
        d = Decoder(src.read_bytes(), backend="numpy", precision="exact")
        want = viewable(d.decode_array(), d.info().pixel_format)
        got = read_png(png.read_bytes())
        if got.shape != want.shape:
            raise AssertionError(f"22 {png.name}: {got.shape} vs "
                                 f"{want.shape}")
        err = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
        lossy_exact = precision == "exact" and kernel != "lossless_recur"
        if err > tol or (kernel == "lossless_recur") != bool(
                launches["lossless_recur"]) or (
                    precision == "fast") != bool(launches["dequant_idct"]) \
                or lossy_exact != bool(launches["idct_exact"]):
            raise AssertionError(f"22 the CLI on {src.name} at {precision}: "
                                 f"max |diff| {err} > {tol}, launches "
                                 f"{launches}")
        done[png.name] = {"shape": list(got.shape), "max_abs_diff": err,
                          "tolerance": tol, "launches": launches}
    say("22 CLI", card=card, pngs=done,
        result="equal to Decoder(backend='numpy') within the tolerance")
    return {"rows": rows, "cli": done}


def phase_e1(jt, data: dict, params, dev, card: str) -> dict:
    """23. E1 against its plain version on the card, tolerance 0: at every
    scale on `adversarial_blocks` (16-bit tables times full-range
    coefficients, zeroed AC columns under large DC) and on every fixture's
    stores with its tables, also against the plain version on the CPU; a
    group of 16 images x 3 components with per-image tables (48 segments)
    SHA-256-equal to per-image launches in one launch, 17 x 4 segments in
    two; a store off a 16-byte boundary refused; one exact large_420
    decode, one E1 launch. Times at large_420's main-path shapes: E1 and
    its plain version by CUDA events. Returns E1's numbers."""
    from torch_inputs import adversarial_blocks
    from jpeg_decoder_tpu_torch.ops.idct import dequantize_and_idct_blocks
    from jpeg_decoder_tpu_torch.ops.kernels import idct_exact_batch

    def plain(coef, q, scale):
        return dequantize_and_idct_blocks(coef, q, scale).reshape(
            coef.shape[0], scale * scale)

    cases = []      # (label, int16 [n, 64] numpy, uint16 [64] table, scale)
    for seed in (0, 1):
        coef, qt = adversarial_blocks(seed, E1_ADVERSARIAL)
        cases += [(f"adversarial {seed}", coef, qt, s) for s in (8, 4, 2, 1)]
    for name in ORDER:
        for store, qt in host_oracle(data[name])._pending_render.values():
            cases += [(name, store.reshape(-1, 64), qt, s)
                      for s in (8, 4, 2, 1)]
    worst, pixels = 0, 0
    for label, coef_np, qt, scale in cases:
        coef = torch.from_numpy(np.ascontiguousarray(coef_np)).to(dev)
        q = params.qt_exact(qt)
        got = idct_exact_batch([coef[None]], [[q]], [scale])[0][0]
        on_card = plain(coef, q, scale)
        on_cpu = plain(coef.cpu(), q.cpu(), scale)
        err = max(int((got.to(torch.int32) - on_card.to(torch.int32))
                      .abs().max()) if got.numel() else 0,
                  int((got.cpu().to(torch.int32) - on_cpu.to(torch.int32))
                      .abs().max()) if got.numel() else 0)
        if err:
            raise AssertionError(f"23 E1 {label} at scale {scale}: max "
                                 f"|diff| {err} from its plain version")
        worst = max(worst, err)
        pixels += got.numel()

    # A group with per-image tables: one launch, each image's own bits.
    rng = np.random.default_rng(23)
    n, blocks = E1_GROUP
    coefs = [torch.from_numpy(rng.integers(-32768, 32768, (n, b, 64))
                              .astype(np.int16)).to(dev) for b in blocks]
    qts = [[params.qt_exact(rng.integers(1, 65536, 64).astype(np.uint16))
            for _ in range(n)] for _ in blocks]
    group, group_launches = counted(
        jt, lambda: idct_exact_batch(coefs, qts, [8, 4, 8]))
    alone = [idct_exact_batch([c[i:i + 1] for c in coefs],
                              [[q[i]] for q in qts], [8, 4, 8])
             for i in range(n)]
    want = [plain(c[i], q[i], s) for i in range(n)
            for c, q, s in zip(coefs, qts, [8, 4, 8])]
    got = [g[i] for i in range(n) for g in group]
    if group_launches["idct_exact"] != 1 \
            or _digest(got) != _digest(a[0] for img in alone for a in img) \
            or any(not torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"23 E1's 48-segment group: {group_launches}")
    wide = [c[:, :8] for c in coefs] + [coefs[0][:, 8:16]]
    wide_q = [[params.qt_exact(rng.integers(1, 256, 64).astype(np.uint16))
               for _ in range(n + 1)] for _ in wide]
    wide = [torch.cat([w, w[:1]]) for w in wide]          # 17 images x 4
    wide_out, wide_launches = counted(
        jt, lambda: idct_exact_batch(wide, wide_q, [8, 4, 2, 1]))
    if wide_launches["idct_exact"] != 2 or any(
            not torch.equal(o[i], plain(w[i], q[i], s))
            for o, w, q, s in zip(wide_out, wide, wide_q, [8, 4, 2, 1])
            for i in range(n + 1)):
        raise AssertionError(f"23 E1 over 68 segments: {wide_launches}")
    odd = torch.zeros(2 * 64 + 4, dtype=torch.int16, device=dev)[4:]
    try:
        idct_exact_batch([odd.view(1, 2, 64)], [[qts[0][0]]], [8])
    except ValueError:
        pass
    else:
        raise AssertionError("23 E1 took a store off a 16-byte boundary")
    per_image = main_path_launches(jt, data["large_420.jpg"], "exact")
    if per_image["idct_exact"] != 1 or per_image["dequant_idct"]:
        raise AssertionError(f"23 one exact large_420 decode: {per_image}")

    # Times at large_420's shapes, as the exact main path calls it.
    renders = host_oracle(data["large_420.jpg"])._pending_render
    stores = [torch.from_numpy(renders[i][0].reshape(1, -1, 64)).to(dev)
              for i in range(len(renders))]
    tables = [params.qt_exact(renders[i][1]) for i in range(len(renders))]
    ms = cuda_ms(lambda: idct_exact_batch(stores, [[q] for q in tables],
                                          [8] * len(stores)), 50)
    plain_ms = cuda_ms(lambda: [plain(s[0], q, 8) for s, q in
                                zip(stores, tables)], 20)
    n_blocks = sum(int(s.shape[1]) for s in stores)
    say("23 E1 vs plain", card=card, cases=len(cases), pixels=pixels,
        max_abs_err=worst, tolerance=0, group_segments=3 * n,
        group_launches=group_launches["idct_exact"],
        group_sha256_equal=True, segments_68_launches=wide_launches[
            "idct_exact"], exact_large_420_launches=per_image,
        large_420_blocks=n_blocks, e1_ms=ms, plain_ms=plain_ms)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


# 24: T1's seeded sweep, per layout its transforms (tests/torch_inputs.py
# T1_LAYOUTS: every upsampler mode, generic at scales 1-4, one and four
# components) at every odd width 1-39 and height 1-5.
TIMED_CALLS = 100   # 24, 25: profiled calls per timed variant (>= 50 seen)
T1_SWEEP = {"444": ("NONE", "RGB", "YCBCR"), "422": ("NONE", "RGB", "YCBCR"),
            "440": ("NONE", "RGB", "YCBCR"), "420": ("NONE", "RGB", "YCBCR"),
            "g31": ("NONE", "RGB", "YCBCR"), "g23": ("NONE", "RGB", "YCBCR"),
            "g44": ("NONE", "RGB", "YCBCR"), "mixed4": ("NONE", "CMYK", "YCCK"),
            "generic4": ("NONE", "CMYK", "YCCK"), "gray": (None,)}


def phase_t1(jt, data: dict, params, dev, card: str) -> dict:
    """24. T1 against its plain version on the card, tolerance 0: every T1
    call of real decodes, captured as the decode makes it (every fixture at
    fast and exact, interleaved and planar; large_420 at 1, 1/2, 1/4 and
    1/8; tower_420 x 16 in one group; the hetero group of the mixed
    sizes; the stripes of large_420 at 4 and 8 and of stripe_420 at 8 on
    slots of the card, halos included); seeded pixels at every odd width
    1-39 and height 1-5 per layout and transform (T1_SWEEP), and
    `T1_CASES` (scales 8/4/2/1, groups of 3, the edges of the kernel's
    tiles), interleaved and planar. T1's CUDA-event ms at large_420's
    main-path shapes beside its plain version's; then T1's own device time
    per launch by variant (torch.profiler, TIMED_CALLS warm calls:
    median, least and largest) beside its bytes bound: large_420 at fast
    and exact, planar, the tower_420 group of 16 and a large_420 stripe
    as the decodes made them, and seeded 4:4:4, 4:2:2 and gray images at
    large_420's size. Returns T1's numbers."""
    from jpeg_decoder_tpu_torch.ops import kernels, pipeline
    from jpeg_decoder_tpu_torch.parallel import make_mesh, stripes
    from tools.torch_port_profile import kernel_device_us
    from torch_inputs import T1_CASES, t1_args, t1_geometry, t1_pixels

    captured, timed = [], {}

    def spy(pixels, *args, **kw):
        out = kernels.interleaved_tail(pixels, *args, **kw)
        if not capturing():
            captured.append((pixels, args, kw, out))
        return out

    def check(label: str, keep: int = None) -> int:
        """Each captured call against the plain version on its inputs; call
        `keep` is kept for the times below."""
        torch.cuda.synchronize()
        if keep is not None:
            timed[label] = captured[keep][:3]
        for pixels, args, kw, out in captured:
            want = kernels.interleaved_tail_plain(pixels, *args, **kw)
            if out.shape != want.shape or not torch.equal(out, want):
                raise AssertionError(f"24 T1 {label}: differs from its "
                                     f"plain version, {args[1:]} {kw}")
        n = len(captured)
        captured.clear()
        return n

    large, tower = data["large_420.jpg"], data["tower_420.jpg"]
    mixed = [(FIXTURES / n).read_bytes() for n in MIXED]
    calls = {}
    saved = pipeline.interleaved_tail, stripes.interleaved_tail
    pipeline.interleaved_tail = stripes.interleaved_tail = spy
    try:
        for precision in ("fast", "exact"):
            for layout in ("interleaved", "planar"):
                with jt.DeviceStreamDecoder(host_threads=4, layout=layout,
                                            precision=precision) as dec:
                    dec.decode_stream([data[name] for name in ORDER])
                    calls[f"fixtures {precision} {layout}"] = check(
                        f"fixtures {precision} {layout}")
            with jt.DeviceStreamDecoder(host_threads=4,
                                        precision=precision) as dec:
                for size in EXACT_SCALES:
                    dec.decode_stream([large], scale_to=size)
                calls[f"large_420 scaled {precision}"] = check(
                    f"large_420 scaled {precision}")
                dec.decode_stream([tower] * 16, batch_size=16)
                calls[f"tower_420 x16 {precision}"] = check(
                    f"tower_420 x16 {precision}", keep=0)
                dec.decode_stream(mixed + mixed[:2], batch_size=8)
                calls[f"hetero group {precision}"] = check(
                    f"hetero group {precision}")
        for name, n in (("large_420.jpg", 4), ("large_420.jpg", 8),
                        ("stripe_420.jpg", 8)):
            blob = (FIXTURES / name).read_bytes()
            mesh = eager_lines(make_mesh({"stripe": n}, mesh_devices(n)))
            with jt.DeviceStreamDecoder(mesh=mesh, host_threads=1) as dec:
                dec.decode_striped(blob)
            got = check(f"{name} at {n} stripes", keep=1)
            if got != n:
                raise AssertionError(f"24 {name} at {n} stripes: {got} T1 "
                                     "calls, not one per stripe")
            calls[f"{name} at {n} stripes"] = got
    finally:
        pipeline.interleaved_tail, stripes.interleaved_tail = saved

    seeded = [(layout, t, h, w, 8, 1) for layout, ts in T1_SWEEP.items()
              for t in ts for w in range(1, 40, 2) for h in range(1, 6)]
    for k, (layout, t, h, w, scale, images) in enumerate(seeded + T1_CASES):
        geometry = t1_geometry(layout, h, w, scale, t)
        pixels = t1_pixels(geometry, images, k, dev)
        args = t1_args(geometry)
        for planar in (False, True):
            got = kernels.interleaved_tail(pixels, *args, planar=planar)
            want = kernels.interleaved_tail_plain(pixels, *args,
                                                  planar=planar)
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"24 T1 seeded {layout} {t} {h}x{w} "
                                     f"scale {scale} x{images} planar "
                                     f"{planar}: differs from plain")
    calls["seeded"] = 2 * (len(seeded) + len(T1_CASES))

    # Times at large_420's shapes: E1's pixels of its stores, as the exact
    # main path calls T1.
    geometry = jt.stage_host_bits(large, precision="exact").geometry
    renders = host_oracle(large)._pending_render
    stores = [torch.from_numpy(renders[i][0].reshape(1, -1, 64)).to(dev)
              for i in range(len(renders))]
    pixels = pipeline.exact_pixels_batch(
        geometry, stores, [tuple(renders[i][1] for i in range(len(renders)))],
        params)
    args = t1_args(geometry)
    ms = cuda_ms(lambda: kernels.interleaved_tail(pixels, *args), 50)
    plain_ms = cuda_ms(lambda: kernels.interleaved_tail_plain(pixels, *args),
                       20)
    say("24 T1 vs plain", card=card, calls_checked=calls, max_abs_err=0,
        tolerance=0, large_420_pixels=[list(p.shape) for p in pixels],
        t1_ms=ms, plain_ms=plain_ms)

    fast = pipeline.fast_pixels_batch(
        geometry, stores, [tuple(renders[i][1] for i in range(len(renders)))],
        params)
    variants = {"large_420 fast": (fast, args, {}),
                "large_420 exact": (pixels, args, {}),
                "large_420 exact planar": (pixels, args, {"planar": True}),
                "tower_420 x16 fast": timed["tower_420 x16 fast"],
                "large_420 stripe 2 of 4": timed["large_420.jpg at 4 stripes"]}
    for layout, t in (("444", "YCBCR"), ("422", "YCBCR"), ("gray", None)):
        g = t1_geometry(layout, geometry.out_height, geometry.out_width, 8, t)
        variants[f"{layout} {g.out_width}x{g.out_height}"] = (
            t1_pixels(g, 1, 24, dev), t1_args(g), {})
    times = t1_times(variants, kernel_device_us)
    say("24 T1 times", card=card, **times)
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "times": times}


def t1_times(variants: dict, kernel_device_us) -> dict:
    """T1's device time per launch for each `variants[label] = (pixels,
    args, kwargs)` of `interleaved_tail` (`launch_times`), beside the bytes
    bound of the call (its block pixels and halos read once, its output
    written once)."""
    from jpeg_decoder_tpu_torch.ops.kernels import interleaved_tail

    times = {}
    for label, (px, a, kw) in variants.items():
        out = interleaved_tail(px, *a, **kw)
        stripe = kw.get("stripe")
        halos = [h for pair in (stripe.halos if stripe else ()) if pair
                 for h in pair]
        nbytes = (sum(p.numel() for p in px) + out.numel()
                  + sum(h.numel() for h in halos))
        times[label] = {**launch_times(
            lambda: interleaved_tail(px, *a, **kw), "interleaved_tail_kernel",
            nbytes, kernel_device_us), "images": px[0].shape[0]}
    return times


def launch_times(fn, symbol: str, nbytes: int, kernel_device_us) -> dict:
    """The device time per launch of the kernels named `symbol` that `fn`
    launches: median, least and largest over TIMED_CALLS profiled calls,
    beside the bytes bound of `nbytes` (each input read once, each output
    written once)."""
    each = sorted(kernel_device_us(fn, symbol,
                                   iters=TIMED_CALLS)["each_us"])
    return {"median_us": each[len(each) // 2], "min_us": each[0],
            "max_us": each[-1], "calls": len(each), "bytes": nbytes,
            "bound_us": bound(nbytes)[0]}


def phase_a1_u1(jt, data: dict, params, dev, card: str) -> dict:
    """25. A1 (the assembly) and U1 (the delta unpack) against their plain
    versions on the card, tolerance 0: every A1 and U1 call of real
    decodes, captured as the decode makes it (every fixture at fast and
    exact, small_dri's restart segments among them; tower_420 x 16 in one
    group; the hetero group; the progressive fixtures and the quirk stream
    through the transcode; large_420 with three table pairs on the anchor
    wire; the stripes of large_420 at 4 and 8 and of stripe_420 at 8, each
    A1 call with its carry); `A1_CASES` (padded grids, restart segments
    across the tiles, 36-tile sequences, groups, carries with high bits
    set, general maps), every fixture's plan forced through the general
    branch, and U1 on seeded wires of every bit pattern and on the merged
    wires of large_420 x4 and x16 (one launch each, over several tiles).
    Times: A1 and U1 by CUDA events at large_420's main-path shapes beside
    their plain versions (U1 also beside `torch.cumsum`); each kernel's
    device time per launch by variant (torch.profiler, TIMED_CALLS warm
    calls: median, least, largest) beside its bytes bound (U1 also beside
    `torch.cumsum`'s and its launch floor, `u1_times`). Returns their
    numbers."""
    import copy

    from jpeg_decoder_tpu_torch.entropy.assemble import (GeneralMaps,
                                                         assemble_nat,
                                                         assemble_nat_plain)
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import (
        U1_TILE, decode_chunks, unpack_delta, unpack_delta_plain)
    from jpeg_decoder_tpu_torch.models import stream
    from jpeg_decoder_tpu_torch.parallel import make_mesh, stripe_bits
    from tools.torch_port_profile import kernel_device_us
    from torch_inputs import (A1_CASES, a1_case, quirk_jpeg,
                              three_table_pairs)

    a1_calls, u1_calls = [], []

    def a1_spy(nat, plan, maps=None, carry=None):
        out = assemble_nat(nat, plan, maps, carry)
        if not capturing():
            a1_calls.append((nat, plan, maps, carry, out))
        return out

    def u1_spy(dm):
        out = unpack_delta(dm)
        if not capturing():
            u1_calls.append((dm, out))
        return out

    def check(label: str) -> tuple:
        torch.cuda.synchronize()
        for nat, plan, maps, carry, out in a1_calls:
            want = assemble_nat_plain(nat, plan, maps, carry)
            if len(out) != len(want) or not all(
                    g.shape == w.shape and torch.equal(g, w)
                    for g, w in zip(out, want)):
                raise AssertionError(f"25 A1 {label}: differs from its "
                                     f"plain version, {tuple(nat.shape)}")
        for dm, out in u1_calls:
            if not all(torch.equal(g, w)
                       for g, w in zip(out, unpack_delta_plain(dm))):
                raise AssertionError(f"25 U1 {label}: differs from its "
                                     f"plain version, {dm.numel()} entries")
        n = (len(a1_calls), len(u1_calls))
        a1_calls.clear()
        u1_calls.clear()
        return n

    large, tower = data["large_420.jpg"], data["tower_420.jpg"]
    mixed = [(FIXTURES / n).read_bytes() for n in MIXED]
    odd = [(FIXTURES / n).read_bytes() for n in PROGRESSIVE] + [
        quirk_jpeg(0), three_table_pairs(large)]
    calls, timed = {}, {}
    saved = stream.assemble_nat, stream.unpack_delta, stripe_bits.assemble_nat
    stream.assemble_nat = stripe_bits.assemble_nat = a1_spy
    stream.unpack_delta = u1_spy
    try:
        for precision in ("fast", "exact"):
            with jt.DeviceStreamDecoder(host_threads=4,
                                        precision=precision) as dec:
                dec.decode_stream([data[name] for name in ORDER])
                calls[f"fixtures {precision}"] = check(f"fixtures "
                                                       f"{precision}")
                dec.decode_stream([tower] * 16, batch_size=16)
                if precision == "fast":
                    timed["A1 tower_420 x16"] = a1_calls[0][:4]
                    timed["U1 tower_420 x16"] = u1_calls[0][0]
                calls[f"tower_420 x16 {precision}"] = check(
                    f"tower_420 x16 {precision}")
                if precision == "fast":
                    # Merged wires of many U1 tiles, one launch each.
                    for count in (4, 16):
                        jt.reset_launches()
                        dec.decode_stream([large] * count, batch_size=count)
                        if len(u1_calls) != 1 \
                                or jt.LAUNCHES["unpack_delta"] != 1 \
                                or u1_calls[0][0].numel() <= U1_TILE:
                            raise AssertionError(
                                f"25 large_420 x{count}: "
                                f"{jt.LAUNCHES['unpack_delta']} U1 launches "
                                f"over {len(u1_calls)} wires, not one of "
                                f"more than {U1_TILE} entries")
                        timed[f"U1 large_420 x{count}"] = u1_calls[0][0]
                        calls[f"large_420 x{count} fast"] = check(
                            f"large_420 x{count} fast")
                dec.decode_stream(mixed + mixed[:2], batch_size=8)
                calls[f"hetero group {precision}"] = check(
                    f"hetero group {precision}")
                dec.decode_stream(odd)
                calls[f"progressive, quirk, three pairs {precision}"] = \
                    check(f"progressive, quirk, three pairs {precision}")
        for name, n in (("large_420.jpg", 4), ("large_420.jpg", 8),
                        ("stripe_420.jpg", 8)):
            mesh = eager_lines(make_mesh({"stripe": n}, mesh_devices(n)))
            with jt.DeviceStreamDecoder(mesh=mesh, host_threads=1) as dec:
                dec.decode_striped((FIXTURES / name).read_bytes())
            if name == "large_420.jpg" and n == 4:
                timed["A1 large_420 stripe 2 of 4"] = a1_calls[1][:4]
            if any(c[3] is None for c in a1_calls):
                raise AssertionError(f"25 {name} at {n} stripes: an A1 "
                                     "call without its carry")
            got = check(f"{name} at {n} stripes")
            if got != (n, 0):
                raise AssertionError(f"25 {name} at {n} stripes: {got} A1 "
                                     "and U1 calls, not one A1 per stripe")
            calls[f"{name} at {n} stripes"] = got
    finally:
        stream.assemble_nat, stream.unpack_delta, \
            stripe_bits.assemble_nat = saved

    seeded = 0
    for case in A1_CASES:
        plan, nat_np, carry_np = a1_case(case)
        maps = None if plan.structured is not None else GeneralMaps(plan,
                                                                    dev)
        nat = torch.from_numpy(nat_np).to(dev)
        for carry in ((None,) if carry_np is None else (
                None, torch.from_numpy(carry_np).to(dev),
                torch.from_numpy(carry_np[:, 0].copy()).to(dev))):
            a1_calls.append((nat, plan, maps, carry,
                             assemble_nat(nat, plan, maps, carry)))
            seeded += 1
    for name in ORDER:
        for st in jt.stage_host_bits(data[name]).scans:
            plan = copy.copy(st.scan.plan)
            plan.structured = None
            dm = torch.from_numpy(st.dm).to(dev)
            ab, base = unpack_delta(dm)
            u1_calls.append((dm, (ab, base)))
            nat = decode_chunks(torch.from_numpy(st.words).to(dev), dm, ab,
                                base, params.tables(st.scan), st.s_max,
                                plan.n_blocks)
            maps = GeneralMaps(plan, dev)
            a1_calls.append((nat, plan, maps, None,
                             assemble_nat(nat, plan, maps)))
            seeded += 1
    rng = np.random.default_rng(25)
    for n in (1, 31, U1_TILE - 1, U1_TILE, U1_TILE + 1, 4 * U1_TILE + 3,
              100_000, 1 << 20, (1 << 20) + 1):
        dm = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                              .astype(np.uint32).view(np.int32)).to(dev)
        u1_calls.append((dm, unpack_delta(dm)))
    calls["seeded"] = check("seeded")

    # Times at large_420's main-path shapes: K1's nat, the delta wire.
    (st,) = jt.stage_host_bits(large).scans
    dm = torch.from_numpy(st.dm).to(dev)
    ab, base = unpack_delta(dm)
    plan = st.scan.plan
    nat = decode_chunks(torch.from_numpy(st.words).to(dev), dm, ab, base,
                        params.tables(st.scan), st.s_max, plan.n_blocks)
    a1_ms = cuda_ms(lambda: assemble_nat(nat, plan), 50)
    a1_plain_ms = cuda_ms(lambda: assemble_nat_plain(nat, plan), 20)
    u1_ms = cuda_ms(lambda: unpack_delta(dm), 50)
    u1_plain_ms = cuda_ms(lambda: unpack_delta_plain(dm), 20)
    sums = u1_sums(dm)
    u1_library_ms = cuda_ms(lambda: torch.cumsum(sums, 1, dtype=torch.int32),
                            50)
    say("25 A1 and U1 vs plain", card=card, calls_checked=calls,
        max_abs_err=0, tolerance=0, a1_ms=a1_ms, a1_plain_ms=a1_plain_ms,
        u1_ms=u1_ms, u1_plain_ms=u1_plain_ms, u1_library_ms=u1_library_ms)

    times = {}
    variants = {"A1 large_420": (nat, plan, None, None),
                **{k: v for k, v in timed.items() if k.startswith("A1")}}
    for label, (v_nat, v_plan, v_maps, v_carry) in variants.items():
        stores = assemble_nat(v_nat, v_plan, v_maps, v_carry)
        nbytes = v_nat.numel() * 2 + sum(t.numel() * 2 for t in stores)
        times[label] = launch_times(
            lambda: assemble_nat(v_nat, v_plan, v_maps, v_carry),
            "assemble_kernel", nbytes, kernel_device_us)
    times.update(u1_times({
        "U1 large_420": dm,
        "U1 tower_420 x16": timed["U1 tower_420 x16"],
        "U1 65,536 entries": dm.repeat(11)[:65536],
        "U1 large_420 x16": timed["U1 large_420 x16"],
        "U1 1,048,576 entries": dm.repeat(171)[:1 << 20]},
        kernel_device_us))
    say("25 A1 and U1 times", card=card, **times)
    return {"max_abs_err": 0, "a1_ms": a1_ms, "a1_plain_ms": a1_plain_ms,
            "u1_ms": u1_ms, "u1_plain_ms": u1_plain_ms,
            "u1_library_ms": u1_library_ms, "times": times, "calls": calls}


def u1_sums(dm: torch.Tensor) -> torch.Tensor:
    """The two columns U1 sums, int32 [2, n]: the deltas (dm >>> 9) and the
    budgets ((dm >>> 4) & 31), the input of the library call beside it."""
    u = dm.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([u >> 9, (u >> 4) & 31]).to(torch.int32)


def u1_times(wires: dict, kernel_device_us) -> dict:
    """U1's device time per launch on each of `wires` (`launch_times`), and
    beside it the device time of `torch.cumsum(x, 1, dtype=torch.int32)`
    over the wire's two columns (`u1_sums`: both of U1's sums, the
    exclusive one aside, in one library call) and the launch floor: the
    device time of U1's kernel with its body taken out (built from the
    checkout's source by `tools/experiments/a1_breakdown.py::build`),
    launched as U1 launches it, on the same wire. `floor_bound_us` is the
    larger of the bytes bound and that floor."""
    from jpeg_decoder_tpu_torch import _build
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import unpack_delta
    from tools.experiments.a1_breakdown import U1_EMPTY, build

    lib = _build.load()
    out = ROOT / "build" / "a1_breakdown" / "u1_empty.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    build(U1_EMPTY, (_build.CSRC / "unpack_delta.cu").read_text(), out)
    empty = ctypes.CDLL(str(out)).jdt_unpack_delta
    real = lib.jdt_unpack_delta
    empty.argtypes, empty.restype = real.argtypes, real.restype
    times = {}
    for label, wire in wires.items():
        row = launch_times(lambda: unpack_delta(wire), "unpack_delta_kernel",
                           12 * wire.numel(), kernel_device_us)
        sums = u1_sums(wire)
        lib_call = kernel_device_us(
            lambda: torch.cumsum(sums, 1, dtype=torch.int32), "",
            iters=TIMED_CALLS)
        lib.jdt_unpack_delta = empty
        try:
            each = sorted(kernel_device_us(
                lambda: unpack_delta(wire), "unpack_delta_kernel",
                iters=TIMED_CALLS)["each_us"])
        finally:
            lib.jdt_unpack_delta = real
        floor = each[len(each) // 2]
        times[label] = {**row, "entries": wire.numel(),
                        "cumsum_device_us": lib_call["all_device_us"],
                        "cumsum_launches": lib_call["all_launches"],
                        "floor_us": floor, "floor_min_us": each[0],
                        "floor_bound_us": max(row["bound_us"], floor)}
    return times


class P1D1Calls:
    """Spies on P1 (`models/stream.py`'s `prefix_stores`) and D1
    (`parallel/stripe_bits.py`'s `dc_totals`) while installed: every call
    of the real decodes but a graph's capture (which launches nothing),
    each held against its plain version on the same inputs (P1's copied
    when it ran where they are views of a graph's arena, which takes the
    next call's) with tolerance 0 by `check(label)`, which counts the
    calls under that label."""

    def __init__(self):
        self.p1, self.d1, self.counts = [], [], {}
        self.saved = None

    def install(self) -> None:
        from jpeg_decoder_tpu_torch.models import stream
        from jpeg_decoder_tpu_torch.parallel import stripe_bits

        self.saved = real_p1, real_d1 = (stream.prefix_stores,
                                         stripe_bits.dc_totals)

        def p1(geometry, *wire):
            out = real_p1(geometry, *wire)
            if not capturing():
                # A graph's inputs are views of its arena, which a later
                # call refills: those are copied as they are now.
                self.p1.append((geometry, tuple(
                    w.clone() if w.untyped_storage().nbytes() > w.nbytes
                    else w for w in wire), out))
            return out

        def d1(nat, plan):
            out = real_d1(nat, plan)
            self.d1.append((nat, plan, out))
            return out

        stream.prefix_stores, stripe_bits.dc_totals = p1, d1

    def remove(self) -> None:
        from jpeg_decoder_tpu_torch.models import stream
        from jpeg_decoder_tpu_torch.parallel import stripe_bits

        stream.prefix_stores, stripe_bits.dc_totals = self.saved

    def check(self, label: str) -> dict:
        from jpeg_decoder_tpu_torch.entropy.assemble import dc_totals_plain
        from jpeg_decoder_tpu_torch.entropy.prefix import prefix_stores_plain

        torch.cuda.synchronize()
        for geometry, wire, out in self.p1:
            want = prefix_stores_plain(geometry, *wire)
            if len(out) != len(want) or any(g.shape != w.shape
                                            for g, w in zip(out, want)):
                raise AssertionError(f"26 P1 {label}: shapes differ")
            err = max(int((g.int() - w.int()).abs().max()) if g.numel()
                      else 0 for g, w in zip(out, want))
            if err:
                raise AssertionError(f"26 P1 {label}: differs from its plain "
                                     f"version by {err}, dc "
                                     f"{tuple(wire[0].shape)}")
        for nat, plan, out in self.d1:
            err = int((out - dc_totals_plain(nat, plan)).abs().max())
            if err:
                raise AssertionError(f"26 D1 {label}: differs from its plain "
                                     f"version by {err}, {tuple(nat.shape)}")
        got = self.counts[label] = {"P1": len(self.p1), "D1": len(self.d1)}
        self.p1.clear()
        self.d1.clear()
        return got


def phase_p1_d1(jt, data: dict, params, dev, card: str,
                calls: P1D1Calls) -> dict:
    """26. P1 (the prefix rebuild) and D1 (a stripe's DC totals) against
    their plain versions on the card, tolerance 0: every call of the real
    decodes of phases 14, 17, 19, 21 and 22 (`calls`, checked after each)
    and here the in-process counterparts of phase 20's (tower_420 and
    tower_420_q92 alternating in a prefix group of 16 on {"data": 8} slots
    at exact, stripe_420.jpg striped over 8) and the q100 fixture through
    the prefix route; seeded P1 wires (`P1_SHAPES`: duplicate,
    out-of-range and negative indices, an empty residual list, block
    counts around P1's tiles; a residual on each half of a 32-bit
    word; an AC array off its 16-byte boundary), prefix groups of 1 to 16
    tower_420; seeded D1 nat of 1 and 3 images of every fixture's plan and
    of large_420's stripe plans at 4 and 8. Times at large_420's shapes: CUDA
    events for the wrapper and its plain version, device µs by kernel name
    (torch.profiler, 50 warm calls: the mean, median, least and largest
    launch) beside the bound; P1 also on the tower_420 x16 group, D1 on
    large_420 stripes at 4 and 8, beside `dc.sum(1)` over its
    [b, n_mcus, plen] DC view."""
    from jpeg_decoder_tpu_torch.entropy.assemble import (dc_totals,
                                                         dc_totals_plain)
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import decode_chunks
    from jpeg_decoder_tpu_torch.entropy.prefix import (prefix_stores,
                                                       prefix_stores_plain)
    from jpeg_decoder_tpu_torch.host.staging import stage_host
    from jpeg_decoder_tpu_torch.models.stream import _prefix_wire
    from jpeg_decoder_tpu_torch.parallel import make_mesh
    from jpeg_decoder_tpu_torch.parallel.stripe_bits import (
        split_anchored_stripes, stripe_wire)
    from tools.torch_port_profile import kernel_device_us
    from torch_inputs import P1_SHAPES, p1_case, whole_geometry

    def card_of(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    tower = data["tower_420.jpg"]
    q92 = (FIXTURES / "tower_420_q92.jpg").read_bytes()
    q100 = (FIXTURES / "q100" / "q100_420.jpg").read_bytes()
    calls.install()
    try:
        mesh = make_mesh({"data": 8}, mesh_devices(8))
        with jt.DeviceStreamDecoder(mesh=mesh, host_threads=2,
                                    interchange="prefix",
                                    precision="exact") as dec:
            dec.decode_stream([tower, q92] * 8, batch_size=16)
        calls.check("20 prefix group on {'data': 8}")
        mesh = eager_lines(make_mesh({"stripe": 8}, mesh_devices(8)))
        with jt.DeviceStreamDecoder(mesh=mesh, host_threads=1) as dec:
            img = dec.decode_striped((FIXTURES / "stripe_420.jpg")
                                     .read_bytes())
        if calls.check("20 stripe_420 at 8")["D1"] != 8 or not np.array_equal(
                img.cpu().numpy(), host_exact((FIXTURES / "stripe_420.jpg")
                                              .read_bytes())):
            raise AssertionError("26 stripe_420 at 8: not one D1 a stripe, "
                                 "or differs from the host exact decode")
        with jt.DeviceStreamDecoder(host_threads=1, interchange="prefix",
                                    precision="exact") as dec:
            (img,) = dec.decode_stream([q100])
        if not np.array_equal(img.cpu().numpy(), host_exact(q100)):
            raise AssertionError("26 q100 prefix differs from the host exact "
                                 "decode")
        calls.check("q100 prefix exact")
    finally:
        calls.remove()

    # Seeded P1 wires and prefix groups of 1 to 16, through the spy's check.
    for images, blocks, entries in P1_SHAPES:
        wire = card_of(p1_case(images, blocks, entries,
                               seed=images * 1000 + blocks))
        geometry = whole_geometry(blocks)
        calls.p1.append((geometry, wire, prefix_stores(geometry, *wire)))
    dc, ac, _i, _v = card_of(p1_case(1, 3, 0, seed=5))
    for idx in ([64], [65], [64, 65], [65, 64, 65, 64], [127, 126, 127]):
        wire = (dc, ac, torch.tensor(idx, dtype=torch.int32, device=dev),
                torch.full((len(idx),), 32767, dtype=torch.int16,
                           device=dev))
        calls.p1.append((whole_geometry(3), wire,
                         prefix_stores(whole_geometry(3), *wire)))
    dc, ac, idx, vals = card_of(p1_case(1, 600, 500, seed=9))
    raw = torch.zeros(ac.numel() + 16, dtype=torch.int8, device=dev)
    off = (1 - raw.data_ptr()) % 16
    shifted = raw[off:off + ac.numel()].view(1, 600, 15)
    shifted.copy_(ac)
    calls.p1.append((whole_geometry(600), (dc, shifted, idx, vals),
                     prefix_stores(whole_geometry(600), dc, shifted, idx,
                                   vals)))
    with jt.DeviceStreamDecoder(host_threads=1, interchange="prefix") as dec:
        one = dec.stage(tower)
        for n in range(1, 17):
            wire = dec._put_recorded(_prefix_wire([one] * n, n))
            calls.p1.append((one.geometry, wire,
                             prefix_stores(one.geometry, *wire)))
    st = stage_host(data["large_420.jpg"])
    wire = card_of((st.dc, st.ac, st.resid_idx, st.resid_vals))
    seeded_p1 = calls.check("seeded P1")["P1"]

    rng = np.random.default_rng(26)
    plans = {name: jt.stage_host_bits(data[name]).scans[0].scan.plan
             for name in ORDER}
    large_scan = jt.stage_host_bits(data["large_420.jpg"]).scans[0].scan
    splits = {n: split_anchored_stripes(large_scan, n) for n in (4, 8)}
    for n, split in splits.items():
        plans[f"large_420 stripe at {n}"] = split.plan
    for label, plan in plans.items():
        for images in (1, 3):
            nat = torch.from_numpy(rng.integers(
                -32768, 32768, (images, plan.n_blocks, 64),
                dtype=np.int16)).to(dev)
            calls.d1.append((nat, plan, dc_totals(nat, plan)))
    seeded_d1 = calls.check("seeded D1")["D1"]

    # Times at large_420's shapes.
    with jt.DeviceStreamDecoder(host_threads=1, interchange="prefix") as dec:
        tower_wire = dec._put_recorded(_prefix_wire([dec.stage(tower)] * 16,
                                                    16))
    blocks = st.dc.size
    p1_bytes = blocks * (2 + 15 + 128) + 6 * st.resid_idx.size
    tower_blocks = tower_wire[0].numel()
    tower_bytes = tower_blocks * (2 + 15 + 128) + 6 * tower_wire[2].numel()
    p1_ms = cuda_ms(lambda: prefix_stores(st.geometry, *wire), 50)
    p1_plain_ms = cuda_ms(lambda: prefix_stores_plain(st.geometry, *wire), 20)
    times = {}

    def spread(fn, symbol: str) -> dict:
        prof = kernel_device_us(fn, symbol, iters=50)
        each = sorted(prof["each_us"])
        return {"kernel_us": prof["kernel_us"],
                "median_us": each[len(each) // 2], "min_us": each[0],
                "max_us": each[-1], "call_device_us": prof["all_device_us"],
                "call_launches": prof["all_launches"]}

    for label, fn, nbytes in (
            ("P1 large_420", lambda: prefix_stores(st.geometry, *wire),
             p1_bytes),
            ("P1 tower_420 x16", lambda: prefix_stores(one.geometry,
                                                       *tower_wire),
             tower_bytes)):
        base, resid = (spread(fn, "prefix_base_kernel"),
                       spread(fn, "prefix_resid_kernel"))
        times[label] = {"kernel_us": base["kernel_us"] + resid["kernel_us"],
                        "base_pass": base, "residual_pass": resid,
                        "launches_per_call":
                        counted(jt, fn)[1]["prefix_rebuild"],
                        "bytes": nbytes, "bound_us": bound(nbytes)[0]}
    for n, split in splits.items():
        words, dm, ab, base_ = card_of(stripe_wire(split, 1)[0])
        nat = decode_chunks(words, dm, ab, base_, params.tables(large_scan),
                            stripe_wire(split, 1)[1],
                            split.n_blocks_local)[None]
        (n_mcus, _r, _c, plen), _specs = split.plan.structured
        d1_bytes = 32 * nat.shape[0] * nat.shape[1]
        dc_view = nat.view(nat.shape[0], n_mcus, plen, 64)[..., 0]
        lib_prof = kernel_device_us(lambda: dc_view.sum(1), "")
        times[f"D1 large_420 stripe 2 of {n}"] = {
            **spread(lambda: dc_totals(nat, split.plan), "dc_totals_kernel"),
            "launches_per_call": counted(
                jt, lambda: dc_totals(nat, split.plan))[1]["dc_totals"],
            "blocks": nat.shape[1],
            "bytes": d1_bytes, "bound_us": bound(d1_bytes)[0],
            "library_device_us": lib_prof["all_device_us"],
            "library_launches": lib_prof["all_launches"]}
        if n == 4:
            d1_ms = cuda_ms(lambda: dc_totals(nat, split.plan), 50)
            d1_plain_ms = cuda_ms(lambda: dc_totals_plain(nat, split.plan),
                                  20)
            d1_library_ms = cuda_ms(lambda: dc_view.sum(1), 50)
    say("26 P1 and D1 vs plain", card=card, calls_checked=calls.counts,
        seeded={"P1": seeded_p1, "D1": seeded_d1}, max_abs_err=0,
        tolerance=0, p1_ms=p1_ms, p1_plain_ms=p1_plain_ms, d1_ms=d1_ms,
        d1_plain_ms=d1_plain_ms, d1_library_ms=d1_library_ms,
        times=times)
    return {"max_abs_err": 0, "p1_ms": p1_ms, "p1_plain_ms": p1_plain_ms,
            "d1_ms": d1_ms, "d1_plain_ms": d1_plain_ms,
            "d1_library_ms": d1_library_ms, "times": times,
            "calls": dict(calls.counts)}


# 27: each leg's host switch, set in the environment its subprocess starts
# with (`tools/ci_matrix_torch.sh`'s axes; never set in a running process).
MATRIX_LEGS = {"engine-off": {"JPEG_TPU_DISABLE_NATIVE": "1"},
               "spec-4096": {"JPEG_TPU_SPEC_PRESCAN": "4096"},
               "collapse-off": {"JPEG_TPU_CLASS_COLLAPSE": "0"}}
# 27: the kernels the matrix decodes must launch in every leg.
MATRIX_KERNELS = ("huffman_decode", "unpack_delta", "assemble",
                  "dequant_idct", "interleaved_tail", "idct_exact",
                  "prefix_rebuild", "dc_totals")


def _same(got, want) -> bool:
    if isinstance(got, torch.Tensor):
        return got.shape == want.shape and torch.equal(got, want)
    return len(got) == len(want) and all(map(_same, got, want))


def matrix_decodes(jt) -> dict:
    """27's decodes on the card, under the host switches this process
    started with: large_420 (bits, interleaved) at fast and at exact,
    tower_420 x16 at batch 16, the mixed sizes at batch 8, stripe_420.jpg
    on {"stripe": 4} slots of the card and q100_420.jpg on the prefix
    interchange. Per decode: the SHA-256 of its outputs, the launches by
    kernel (counts set to 0 just before it), the SHA-256 of the wires K1
    and P1 read; every K1, U1 and A1 call (spies on `models/stream.py` and
    `parallel/stripe_bits.py`) and every P1 and D1 call (`P1D1Calls`) held
    against its plain version on the same inputs, tolerance 0: a
    difference raises."""
    from jpeg_decoder_tpu_torch.entropy.assemble import (assemble_nat,
                                                         assemble_nat_plain)
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import (
        decode_chunks, decode_chunks_plain, unpack_delta, unpack_delta_plain)
    from jpeg_decoder_tpu_torch.models import stream
    from jpeg_decoder_tpu_torch.parallel import make_mesh, stripe_bits

    plain = {"K1": decode_chunks_plain, "U1": unpack_delta_plain,
             "A1": assemble_nat_plain}
    calls = {key: [] for key in plain}

    def spy(key, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if not capturing():
                calls[key].append((args, out))
            return out
        return call

    def check(label: str) -> dict:
        torch.cuda.synchronize()
        wire = hashlib.sha256()
        for t in [t for args, _out in calls["K1"] for t in args[:4]] + [
                t for _geometry, args, _out in p1d1.p1 for t in args]:
            wire.update(t.cpu().numpy().tobytes())
        for key, made in calls.items():
            for args, out in made:
                if not _same(out, plain[key](*args)):
                    raise AssertionError(f"27 {key} {label}: differs from its "
                                         "plain version")
        n = {key: len(made) for key, made in calls.items()}
        for made in calls.values():
            made.clear()
        return {**n, **p1d1.check(f"27 {label}"),
                "wire_sha256": wire.hexdigest()}

    large = (FIXTURES / "large_420.jpg").read_bytes()
    tower = (FIXTURES / "tower_420.jpg").read_bytes()
    mixed = [(FIXTURES / n).read_bytes() for n in MIXED]
    runs = {"large_420 fast": ({"precision": "fast"}, [large], 1),
            "large_420 exact": ({"precision": "exact"}, [large], 1),
            "tower_420 x16": ({}, [tower] * 16, 16),
            "mixed x8": ({}, mixed + mixed[:2], 8),
            "q100 prefix": ({"interchange": "prefix"},
                            [(FIXTURES / "q100" / "q100_420.jpg")
                             .read_bytes()], 1)}
    saved = (stream.decode_chunks, stream.unpack_delta, stream.assemble_nat,
             stripe_bits.decode_chunks, stripe_bits.assemble_nat)
    stream.decode_chunks = stripe_bits.decode_chunks = spy("K1",
                                                           decode_chunks)
    stream.unpack_delta = spy("U1", unpack_delta)
    stream.assemble_nat = stripe_bits.assemble_nat = spy("A1", assemble_nat)
    p1d1 = P1D1Calls()
    p1d1.install()
    out = {}
    try:
        for label, (opts, sources, batch) in runs.items():
            with jt.DeviceStreamDecoder(host_threads=4, **opts) as dec:
                images, launches = counted(
                    jt, lambda: dec.decode_stream(sources, batch_size=batch))
            out[label] = {"sha256": _digest(images), "launches": launches,
                          "checked": check(label)}
        mesh = eager_lines(make_mesh({"stripe": 4}, mesh_devices(4)))
        with jt.DeviceStreamDecoder(mesh=mesh, host_threads=1) as dec:
            image, launches = counted(jt, lambda: dec.decode_striped(
                (FIXTURES / "stripe_420.jpg").read_bytes()))
        out["stripe_420 at 4"] = {"sha256": _digest([image]),
                                  "launches": launches,
                                  "checked": check("stripe_420 at 4")}
    finally:
        p1d1.remove()
        (stream.decode_chunks, stream.unpack_delta, stream.assemble_nat,
         stripe_bits.decode_chunks, stripe_bits.assemble_nat) = saved
    return out


def matrix_leg() -> int:
    """`chip_smoke.py --matrix-leg`: one leg of phase 27 in this process,
    whose environment holds the leg's host switch. Prints one JSON line:
    whether the native host library staged the inputs, the decodes'
    records (`matrix_decodes`) and their seconds."""
    if not torch.cuda.is_available():
        print("chip_smoke --matrix-leg: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import jpeg_decoder_tpu_torch as jt
    from jpeg_decoder_tpu_torch import _build
    from jpeg_decoder_tpu_torch.host.entropy.native import get_native

    _build.load()
    t0 = time.perf_counter()
    runs = matrix_decodes(jt)
    print(json.dumps({"native": get_native() is not None, "runs": runs,
                      "decode_seconds": time.perf_counter() - t0}))
    return 0


def phase_matrix(jt, card: str) -> dict:
    """27. The main path along the host switches: `matrix_decodes` here
    under the default switches (the native engine), then once per leg of
    MATRIX_LEGS in a subprocess (`chip_smoke.py --matrix-leg`) started with
    that switch and no other JPEG_TPU_* variable. Each leg must stage with
    the engine its switch selects, give every output SHA-256-equal to the
    default decode, launch each of MATRIX_KERNELS, and hold every K1, U1,
    A1, P1 and D1 call to its plain version (the leg raises otherwise).
    Returns each leg's seconds (the subprocess's wall time, its start
    included), launches by kernel and verdicts."""
    from jpeg_decoder_tpu_torch.host.entropy.native import get_native

    if get_native() is None:
        raise AssertionError("27: the default decodes need the native host "
                             "library")

    def totals(runs: dict) -> tuple:
        return ({k: sum(run["launches"][k] for run in runs.values())
                 for k in jt.LAUNCHES},
                {k: sum(run["checked"][k] for run in runs.values())
                 for k in ("K1", "U1", "A1", "P1", "D1")})

    t0 = time.perf_counter()
    default = matrix_decodes(jt)
    launches, checked = totals(default)
    legs = {"default": {"seconds": time.perf_counter() - t0, "native": True,
                        "launches": launches, "checked": checked,
                        "runs": default}}
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JPEG_TPU_")}
    for leg, switch in MATRIX_LEGS.items():
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                              "--matrix-leg"], cwd=ROOT,
                             env={**env, **switch}, capture_output=True,
                             text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"27 {leg}: exit {res.returncode}\n"
                                 f"{res.stderr[-4000:]}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        if got["native"] != (leg != "engine-off"):
            raise AssertionError(f"27 {leg}: native host library engaged "
                                 f"{got['native']}")
        if got["runs"].keys() != default.keys():
            raise AssertionError(f"27 {leg}: decodes {list(got['runs'])}")
        for label, run in got["runs"].items():
            if run["sha256"] != default[label]["sha256"]:
                raise AssertionError(f"27 {leg} {label}: output differs from "
                                     "the default decode")
        wire_equal = {label: run["checked"]["wire_sha256"]
                      == default[label]["checked"]["wire_sha256"]
                      for label, run in got["runs"].items()}
        launches, checked = totals(got["runs"])
        if min(launches[k] for k in MATRIX_KERNELS) < 1 \
                or min(checked.values()) < 1:
            raise AssertionError(f"27 {leg}: launches {launches}, calls "
                                 f"checked {checked}")
        legs[leg] = {"seconds": seconds, "native": got["native"],
                     "decode_seconds": got["decode_seconds"],
                     "launches": launches, "checked": checked,
                     "sha256_equal_default": True,
                     "wire_equal_default": wire_equal, "runs": got["runs"]}
        say(f"27 matrix {leg}", card=card,
            **{k: v for k, v in legs[leg].items() if k != "runs"})
    return legs


# 28: the routes the compiled dispatch covers: (label, decoder options,
# source, batch), batch 1 one image (`_run_device`), else one same-key
# group of `batch` copies (`_run_group`); a source is a fixture's name or
# ("sof3", side, predictor), a 16-bit SOF3 stream (`sof3_blob`).
PREFIX = {"interchange": "prefix"}
GRAPH_ROUTES = (
    [(f"large_420 {p} {lay}", {"precision": p, "layout": lay},
      "large_420.jpg", 1)
     for p in ("fast", "exact")
     for lay in ("interleaved", "planar", "planar-pallas")]
    + [("tower_420 fast x1", {}, "tower_420.jpg", 1),
       ("tower_420 fast x16", {}, "tower_420.jpg", 16),
       ("tower_420 exact x16", {"precision": "exact"}, "tower_420.jpg", 16)]
    + [(f"prefix large_420 {p} {lay}",
        {**PREFIX, "precision": p, "layout": lay}, "large_420.jpg", 1)
       for p in ("fast", "exact")
       for lay in ("interleaved", "planar", "planar-pallas")]
    + [("prefix tower_420 fast x16", PREFIX, "tower_420.jpg", 16)]
    + [(f"SOF3 512x512 predictor {p} x8", {}, ("sof3", SOF3_SLICE[0], p), 8)
       for p in (1, 6)]
    + [(f"SOF3 2048x2048 predictor {p}", {}, ("sof3", SOF3_SIDE, p), 1)
       for p in (1, 6)])
# 28: the routes timed eager beside replay.
GRAPH_TIMED = ("large_420 fast interleaved", "large_420 exact interleaved",
               "tower_420 fast x1", "tower_420 fast x16",
               "prefix large_420 fast interleaved",
               "prefix large_420 exact interleaved",
               "prefix tower_420 fast x16", "SOF3 512x512 predictor 1 x8",
               "SOF3 512x512 predictor 6 x8", "SOF3 2048x2048 predictor 1",
               "SOF3 2048x2048 predictor 6")
GRAPH_REPLAYS = 10_000


@functools.lru_cache(maxsize=None)
def sof3_blob(side: int, predictor: int) -> bytes:
    """A side x side 16-bit one-component SOF3 stream of seeded samples at
    `predictor`, point transform 0."""
    from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

    return sof3_jpeg(sof3_samples(side, side, 1, 16, 0, seed=0), predictor,
                     0, 16)


def route_blob(data: dict, source) -> bytes:
    """A GRAPH_ROUTES source's bytes."""
    if isinstance(source, tuple):
        return sof3_blob(*source[1:])
    return data[source]


def graph_calls(dec, blob: bytes, batch: int) -> dict:
    """Calls of `blob`'s key on `dec` (one image, or a same-key group of
    `batch` copies), each returning the [N, ...] output: "first" the
    output of the key's first call (eager, off any graph: it makes no
    graph); "replay" and "eager" on the inputs the second landing put in
    the key's graph (as `device_resident_rate` times them),
    "replay_landed" and "eager_landed" landing them first each time (the
    H2D submission, `_to_device` or `_group_wires`, then the dispatch, as
    `decode_stream` runs them); "fill" the second landing. The first
    "replay" runs the body on the graph's inputs (its warm-up) and
    captures the graph; later ones replay. "kind" the interchange."""
    from jpeg_decoder_tpu_torch.models.stream import _kind

    staged = dec.stage(blob)
    kind = _kind(staged)
    group = [staged] * batch

    def land():
        return dec._to_device(staged) if batch == 1 \
            else dec._group_wires(kind, group)
    first = dec._run_device(staged, land())[None] if batch == 1 \
        else torch.stack(dec._run_group(kind, group, land()))
    fill = land()
    return {"first": first,
            "replay": lambda: dec._graphs.run(dec, fill),
            "eager": lambda: dec._graphs.run(dec, fill, eager=True),
            "replay_landed": lambda: dec._graphs.run(dec, land()),
            "eager_landed": lambda: dec._graphs.run(dec, land(), eager=True),
            "fill": fill, "kind": kind}


def resident(run, iters: int, images: int, reps: int = 3) -> dict:
    """Device ms/image (CUDA events around `iters` back-to-back calls) and
    host ms/image (the enqueue: the first call to the last one's return),
    of the rep with the least device time; after one warm-up call."""
    run()
    torch.cuda.synchronize()
    best = None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            run()
        host = time.perf_counter() - t0
        stop.record()
        stop.synchronize()
        dev = start.elapsed_time(stop)
        if best is None or dev < best[0]:
            best = (dev, host)
    return {"ms_per_image": best[0] / iters / images,
            "host_ms_per_image": best[1] * 1e3 / iters / images}


def idle_share(run, iters: int, images: int) -> dict:
    """The card's share of idle time over `iters` back-to-back calls
    (torch.profiler, the card's activity only, so that the host runs as
    unprofiled as it can: 1 - the union of device operations over the
    wall time, synchronised), the device operations per image and their
    names."""
    from torch.profiler import ProfilerActivity

    from tools.torch_port_profile import _busy_us, _kernels

    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = _kernels(prof)
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in ops)
    names: dict = {}
    for e in ops:
        names[e.name] = names.get(e.name, 0) + 1
    return {"idle_share": 1 - busy / (wall * 1e6),
            "busy_ms_per_image": busy / 1e3 / iters / images,
            "wall_ms_per_image": wall * 1e3 / iters / images,
            "device_ops_per_image": len(ops) / iters / images,
            "ops_by_name_per_call": {k: v / iters for k, v in names.items()}}


# 28: a wrapper's LAUNCHES key -> the names of the kernels it launches.
KERNEL_SYMBOLS = {"huffman_decode": ("huffman_decode_kernel",),
                  "unpack_delta": ("unpack_delta_kernel",),
                  "assemble": ("assemble_kernel",),
                  "dequant_idct": ("dequant_idct_kernel",),
                  "idct_exact": ("idct_exact_kernel",),
                  "interleaved_tail": ("interleaved_tail_kernel",),
                  "fused_tail": ("fused_tail_kernel",),
                  "prefix_rebuild": ("prefix_base_kernel",
                                     "prefix_resid_kernel"),
                  "lossless_recur": ("lossless_recur_kernel",),
                  "dc_totals": ("dc_totals_kernel",)}
GRAPH_PROFILED = 10     # replays in the profiler's active step
# A trace drops the first operations of its active step: those of the
# first few ms after the host resumes from its last wait (phase 28 of
# long runs: the first call's copy in and first kernels, or all of it, at
# idle margins of 50 ms to 0.8 s before the calls; a spin kernel before
# a 50 ms sleep and one after it, both). So the active step opens with
# PROFILER_FILL_S of spin kernels launched back to back, no wait between
# them and the calls, and counts only what follows the last one it holds;
# a trace that holds none is taken again.
PROFILER_FILL_S = 0.02
SPIN_CYCLES = 1000
GATE_TRACES = 6
STARTED = time.monotonic()


def replay_kernels(run, calls: int = GRAPH_PROFILED,
                   fill: float = PROFILER_FILL_S) -> tuple:
    """The card's operations by name over `calls` calls of `run` in a
    torch.profiler trace's active step, after a warm-up step of 3 calls,
    each step synchronised; the active step opens with `fill` seconds of
    spin kernels and only the operations after the last spin kernel in
    the trace are counted. A trace that holds no spin kernel or counts
    nothing after it is taken again (twice at most). (The operations;
    every other one of the trace in order as [its kernel's name, its
    start less the last spin kernel's, µs]; [spin kernels launched, held
    by the trace].)"""
    from torch.profiler import ProfilerActivity, profile, schedule

    got: dict = {}
    order = []
    spins = [0, 0]

    def traced(prof) -> None:
        got.clear()
        order.clear()
        ev = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        held = [e.time_range.start for e in ev if "spin_kernel" in e.name]
        spins[1] = len(held)
        at = held[-1] if held else 0
        for e in ev:
            if "spin_kernel" in e.name:
                continue
            order.append([kernel_name(e.name),
                          round(e.time_range.start - at, 1)])
            if held and e.time_range.start > at:
                got[e.name] = got.get(e.name, 0) + 1

    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=traced) as prof:
            for n in (3, calls):
                if n == calls:
                    spins[0] = 0
                    end = time.perf_counter() + fill
                    while time.perf_counter() < end:
                        torch.cuda._sleep(SPIN_CYCLES)
                        spins[0] += 1
                for _ in range(n):
                    run()
                torch.cuda.synchronize()
                prof.step()
        if got:
            break
    return got, order, spins


def missed(fill: float, have: dict, want: dict, order: list, spins: list,
           taken: list) -> dict:
    """A retaken trace's record: its fill, the script's seconds so far,
    the spin kernels launched and held, each name's count less the count
    wanted, and for the first two of a gate its operations in order."""
    rec = {"fill": fill, "at_s": time.monotonic() - STARTED,
           "spins": spins,
           "short": {kernel_name(k): have.get(k, 0) - want.get(k, 0)
                     for k in set(have) | set(want)
                     if have.get(k, 0) != want.get(k, 0)}}
    if sum("order" in t for t in taken if isinstance(t, dict)) < 2:
        rec["order"] = order
    return rec


def replay_gate(label: str, replay, eager_calls: dict) -> tuple:
    """The profiler's gate on a route's replays: each kernel of the eager
    body (`eager_calls`, by `LAUNCHES` key) exactly as often in
    GRAPH_PROFILED replays as in as many eager bodies, and no other
    kernel of KERNEL_SYMBOLS. A trace can lose events but not make them
    up, so a trace that counts fewer is taken again with twice the fill
    (GATE_TRACES traces at most) and one exact count passes; (counted,
    ops, the traces taken: [fill s, spin kernels launched, held] of the
    one that passed, after a record (`missed`) of each one retaken)."""
    want = {k: eager_calls.get(k, 0) * GRAPH_PROFILED for k in KERNEL_SYMBOLS}
    taken = []
    for attempt in range(GATE_TRACES):
        fill = PROFILER_FILL_S * 2 ** attempt
        ops, order, spins = replay_kernels(replay, fill=fill)
        counted = {k: sum(n for op, n in ops.items()
                          if any(sym in op for sym in syms))
                   for k, syms in KERNEL_SYMBOLS.items()}
        if counted == want:
            return counted, ops, taken + [[fill, *spins]]
        taken.append(missed(fill, counted, want, order, spins, taken))
        if any(counted[k] > want[k] for k in KERNEL_SYMBOLS):
            break
    raise AssertionError(
        f"28 {label}: the profiler counts {counted} kernels over "
        f"{GRAPH_PROFILED} replays, the eager body {eager_calls}; traces "
        f"{json.dumps(taken)}")


def kernel_name(op: str) -> str:
    """A device operation's name without its signature, template arguments
    and namespaces."""
    name = op.removeprefix("void ").replace("(anonymous namespace)::", "")
    for cut in "<(":
        name = name.split(cut)[0]
    return name.split("::")[-1].strip()


def device_kernels(run, fill: float = PROFILER_FILL_S) -> tuple:
    """The card's kernels by name over GRAPH_PROFILED calls of `run`
    (`replay_kernels`), copies and fills left out, every operation in
    order and the spin kernels."""
    ops, order, spins = replay_kernels(run, fill=fill)
    return {op: n for op, n in ops.items()
            if "Memcpy" not in op and "Memset" not in op}, order, spins


def kernels_gate(label: str, replay, eager) -> tuple:
    """Every kernel, PyTorch's included (the lossless closed forms' scans
    and casts), as often over GRAPH_PROFILED replays as over as many eager
    bodies on the same inputs. A trace can lose events, so a pair that
    differs is taken again with twice the fill (GATE_TRACES pairs at
    most); (kernels, the pairs taken: [fill s, the replays' spin kernels
    launched and held, the eager bodies'] of the one that passed, after
    a record (`missed`, the replays' counts against the eager bodies') of
    each one retaken)."""
    taken = []
    for attempt in range(GATE_TRACES):
        fill = PROFILER_FILL_S * 2 ** attempt
        got, order, spins = device_kernels(replay, fill)
        want, eager_order, eager_spins = device_kernels(eager, fill)
        if got == want and got:
            return got, taken + [[fill, spins, eager_spins]]
        rec = missed(fill, got, want, order, spins, taken)
        rec["eager_spins"] = eager_spins
        if "order" in rec:
            rec["eager_order"] = eager_order
        taken.append(rec)
    raise AssertionError(f"28 {label}: the replays' kernels {got}, the "
                         f"eager bodies' {want}; pairs {json.dumps(taken)}")


def sync_free_replays(label: str, dec, replay, calls: int = 3) -> int:
    """`calls` replays (each landing its inputs first) under
    `torch.cuda.set_sync_debug_mode("error")`: nothing may wait for the
    card, and each must be a replay."""
    torch.cuda.synchronize()
    hits = dec._graphs.hits
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(calls):
            replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if dec._graphs.hits - hits != calls:
        raise AssertionError(f"28 {label}: the sync-free calls were not "
                             "replays")
    return calls


def graph_pool_bytes(graph) -> int:
    """The bytes the caching allocator holds in a captured graph's private
    pool (its segments in `torch.cuda.memory_snapshot()`), or None where
    the snapshot names no segment of it."""
    pool = tuple(graph.graph.pool())
    held = [seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool]
    return sum(held) if held else None


def wrapper_host_us(jt, data: dict) -> dict:
    """Each wrapper of the eager body apart from its kernel, at large_420's
    main-path shapes (fast for K2, exact for E1): its arguments captured by
    spies on one eager decode, then 200 calls back to back, host µs a call
    (the enqueue) beside the kernel's device µs (torch.profiler)."""
    from jpeg_decoder_tpu_torch.models import stream
    from jpeg_decoder_tpu_torch.ops import pipeline
    from tools.torch_port_profile import kernel_device_us

    names = {"K1": (stream, "decode_chunks", "huffman_decode_kernel"),
             "U1": (stream, "unpack_delta", "unpack_delta_kernel"),
             "A1": (stream, "assemble_nat", "assemble_kernel"),
             "K2": (pipeline, "dequant_idct_batch", "dequant_idct_kernel"),
             "E1": (pipeline, "idct_exact_batch", "idct_exact_kernel"),
             "T1": (pipeline, "interleaved_tail", "interleaved_tail_kernel")}
    args: dict = {}
    saved = {k: getattr(mod, fn) for k, (mod, fn, _sym) in names.items()}

    def spy(key):
        real = saved[key]

        def call(*a, **kw):
            args.setdefault(key, (real, a, kw))
            return real(*a, **kw)
        return call

    for key, (mod, fn, _sym) in names.items():
        setattr(mod, fn, spy(key))
    try:
        for precision in ("fast", "exact"):
            with jt.DeviceStreamDecoder(host_threads=1,
                                        precision=precision) as dec:
                staged = dec.stage(data["large_420.jpg"])
                dec._run_device_eager(staged, dec._to_device(staged))
                torch.cuda.synchronize()
    finally:
        for key, (mod, fn, _sym) in names.items():
            setattr(mod, fn, saved[key])
    out = {}
    for key, (_mod, _fn, sym) in names.items():
        real, a, kw = args[key]

        def call():
            return real(*a, **kw)
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        host = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        prof = kernel_device_us(call, sym)
        out[key] = {"host_us": host, "kernel_us": prof["kernel_us"],
                    "device_ops_per_call": prof["all_launches"]}
    return out


# 28: the hetero routes, each on the mixed group of 8 (MIXED and its first
# two again, one sweep and six parts) and on HETERO_SECOND (the same sweep
# key; two of its parts' keys shared, at other offsets).
HETERO_ROUTES = (("mixed x8 fast interleaved", {}),
                 ("mixed x8 exact interleaved", {"precision": "exact"}),
                 ("mixed x8 fast planar-pallas", {"layout": "planar-pallas"}))
HETERO_SECOND = (5, 4, 3, 2, 1, 0, 4, 3)


def hetero_calls(dec, group: list) -> dict:
    """Calls of a hetero group's keys on `dec`, each returning the group's
    images: "replay" and "eager" (the body of each half run eagerly on its
    graph's inputs) on the halves one landing put in the graphs,
    "replay_landed" and "eager_landed" landing them first each time;
    "off_graph_landed" the eager dispatch off any graph (the merged wire
    put to the device, as a mesh shard's group runs); "land" the landing
    alone (the sweep's arena and each part's, one H2D submission each)."""
    def land():
        return dec._group_wires("bits", group)
    halves = land()
    return {"replay": lambda: dec._run_group("bits", group, halves),
            "eager": lambda: dec._run_group_eager("bits", group, halves),
            "replay_landed": lambda: dec._run_group("bits", group, land()),
            "eager_landed":
                lambda: dec._run_group_eager("bits", group, land()),
            "off_graph_landed": lambda: dec._run_group(
                "bits", group, dec._group_halves(
                    group, *dec._bits_merge(group), None, None)),
            "land": land, "halves": halves}


def copy_times(dec, group: list, halves) -> list:
    """Each part's row copy (its rows of the sweep's nat into its graph's
    `nat_in`, the port's `dynamic_slice`), alone: its bytes, CUDA-event ms
    over 200 copies and the device µs of its memcpy (torch.profiler)."""
    from torch.profiler import ProfilerActivity

    nat = dec._run_half(halves.sweep, False)
    out, off = [], 0
    for members, fill in zip(halves.parts.values(), halves.recons):
        rows = len(members) * group[members[0]].scans[0].scan.plan.n_blocks
        src, dst = nat[off:off + rows], fill.graph.nat_in[:rows]

        def copy(src=src, dst=dst):
            dst.copy_(src)
        ms = cuda_ms(copy, 200)
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(20):
                copy()
            torch.cuda.synchronize()
        ev = [e.time_range.elapsed_us() for e in p.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        out.append({"images": len(members), "bytes": rows * 128,
                    "cuda_event_ms": ms,
                    "device_us": sum(ev) / len(ev) if ev else None})
        off += rows
    return out


def phase_hetero_graphs(jt, card: str) -> dict:
    """28, hetero groups: per HETERO_ROUTES the group's first call (every
    key at its first sight: eager, off any graph, no graph made), three
    calls on freshly landed inputs (the warm-up and the captures of the
    sweep graph and the six part graphs, then two replays) and the eager
    body on the same inputs SHA-256-equal, image by image; one capture a
    key; each replay counting the eager body's launches by `LAUNCHES` and
    by the profiler's warmed gate; HETERO_SECOND's first call (the sweep
    and two parts replayed, the other parts eager) and two more, each
    image SHA-256-equal to the same fixture's in the first composition,
    one sweep graph for both; replays of both compositions' warmed keys
    under `torch.cuda.set_sync_debug_mode("error")`. Measured: device and
    host ms/image and the idle share, replay beside the eager body and
    the eager dispatch off any graph; the landing's host µs a group; each
    part's row copy; each graph's pool."""
    mixed = [(FIXTURES / n).read_bytes() for n in MIXED]
    cell = mixed + mixed[:2]
    second = [mixed[i] for i in HETERO_SECOND]
    out = {}
    for label, opts in HETERO_ROUTES:
        with jt.DeviceStreamDecoder(host_threads=1, **opts) as dec:
            group = [dec.stage(b) for b in cell]
            first = dec._run_group("bits", group,
                                   dec._group_wires("bits", group))
            torch.cuda.synchronize()
            if len(dec._graphs):
                raise AssertionError(f"28 {label}: a first sight made a graph")
            calls = hetero_calls(dec, group)
            replay, eager = calls["replay_landed"], calls["eager_landed"]
            jt.reset_launches()
            replays = [replay() for _ in range(3)]  # the first captures
            torch.cuda.synchronize()
            replayed = {k: v / 3 for k, v in jt.LAUNCHES.items() if v}
            jt.reset_launches()
            body = eager()
            torch.cuda.synchronize()
            eager_calls = {k: v for k, v in jt.LAUNCHES.items() if v}
            stats = dec._graphs.stats()
            keys = len(calls["halves"].recons) + 1
            want = [_digest([t]) for t in body]
            if any([_digest([t]) for t in r] != want
                   for r in [first] + replays) \
                    or replayed != eager_calls \
                    or {k: stats[k] for k in ("graphs", "captures", "hits")} \
                    != {"graphs": keys, "captures": keys, "hits": 2 * keys}:
                raise AssertionError(f"28 {label}: replay against eager: "
                                     f"{replayed} {eager_calls} {stats}")
            counted, ops, traces = replay_gate(label, replay, eager_calls)
            # A second composition: the sweep key again, parts at other
            # offsets.
            group2 = [dec.stage(b) for b in second]
            sweep = calls["halves"].sweep.graph
            seconds = []
            for _ in range(3):
                halves2 = dec._group_wires("bits", group2)
                seconds.append(dec._run_group("bits", group2, halves2))
            torch.cuda.synchronize()
            if halves2.sweep.graph is not sweep or any(
                    [_digest([t]) for t in imgs]
                    != [want[i] for i in HETERO_SECOND]
                    for imgs in seconds):
                raise AssertionError(f"28 {label}: the second composition")
            # Warmed keys of both compositions, no synchronisation.
            torch.cuda.synchronize()
            hits = dec._graphs.hits
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(3):
                    replay()
                    dec._run_group("bits", group2,
                                   dec._group_wires("bits", group2))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            sync_free = dec._graphs.hits - hits
            if sync_free != 3 * (keys + len(halves2.recons) + 1):
                raise AssertionError(f"28 {label}: {sync_free} sync-free "
                                     "replays")
            images = len(cell)
            timed = {mode: {**resident(calls[mode], 20, images),
                            **idle_share(calls[mode], 20, images)}
                     for mode in ("replay", "eager", "replay_landed",
                                  "eager_landed", "off_graph_landed")}
            land = calls["land"]
            land()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                land()
            landing_us = (time.perf_counter() - t0) / 50 * 1e6
            torch.cuda.synchronize()
            halves = calls["halves"]
            out[label] = {
                "sha256": _digest(body), "launches_per_group": replayed,
                "profiler_traces": traces,
                "profiler_kernels_per_group": {
                    k: v / GRAPH_PROFILED for k, v in counted.items() if v},
                "profiler_ops_per_group": {
                    op.split("(")[0].split("::")[-1]: n / GRAPH_PROFILED
                    for op, n in ops.items()},
                "graph": dec._graphs.stats(), "sync_free_replays": sync_free,
                "times": timed, "landing_host_us_per_group": landing_us,
                "copies": copy_times(dec, group, halves),
                "pool_bytes": {"sweep": graph_pool_bytes(halves.sweep.graph),
                               "parts": [graph_pool_bytes(f.graph)
                                         for f in halves.recons]},
                "arena_bytes": {"sweep": halves.sweep.graph.arena.numel(),
                                "parts": [f.graph.arena.numel()
                                          for f in halves.recons]}}
    say("28 hetero graphs", card=card, **out)
    return out


@contextlib.contextmanager
def eager_bodies():
    """Every graph call in the block runs its body eagerly on the inputs its
    landing put in the graph's arena (`BitsGraphs.run(eager=True)`), not by
    replay: the eager dispatch a route's replays stand for, through the
    route's own entry point."""
    from jpeg_decoder_tpu_torch.models import graphs

    real = graphs.BitsGraphs.run

    def run(self, dec, fill, eager=False, rows=None):
        return real(self, dec, fill, True, rows)
    graphs.BitsGraphs.run = run
    try:
        yield
    finally:
        graphs.BitsGraphs.run = real


def _flat(out) -> list:
    """A route's output as a list of tensors."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


def mesh_graph_routes(jt, data: dict, dev: torch.device) -> list:
    """28, the mesh and `Decoder` routes: (label, call, caches, runs a call,
    images a call, refs, tol). `call()` is the route's entry point on
    inputs staged once, returning its outputs; `caches` the graph caches
    its keys land in; `runs` the graph runs one call makes (a data shard
    or line each). Every shard, line and run of a call decodes an image
    of its own that shares the route's keys (`requantized` fixtures, SOF3
    slices of other seeds, stores with their DC shifted), and `refs` holds
    each output's own host decode (the exact one; `tol` PIXEL_TOL on a
    fast route, else 0), in `_flat(call())`'s order. `dev` is where
    `Decoder`'s reconstruction runs."""
    from jpeg_decoder_tpu_torch.models import graphs
    from jpeg_decoder_tpu_torch.parallel import make_mesh
    from jpeg_decoder_tpu_torch.parallel.batch import make_batch_pipeline
    from jpeg_decoder_tpu_torch.parallel.stripe_bits import (
        decode_bits_striped, decode_bits_striped_batch)
    from jpeg_decoder_tpu_torch.parallel.stripes import (
        _pad_rows, make_stripe_pipeline)
    from jpeg_decoder_tpu_torch import decoder as port_decoder
    from jpeg_decoder_tpu_torch.models.service import _host_stage
    from tools.make_torch_fixtures import requantized, sof3_jpeg, sof3_samples

    cache = graphs.device_graphs(dev)
    cache.clear()           # the keys earlier phases captured
    routes = []
    for name, n in (("large_420", 4), ("large_420", 8), ("stripe_420", 8)):
        mesh = make_mesh({"stripe": n}, mesh_devices(n))
        blob = (FIXTURES / f"{name}.jpg").read_bytes()
        blobs = [requantized(blob, step) for step in (0, 7)]
        staged = [jt.stage_host_bits(b) for b in blobs]
        routes.append((f"decode_striped {name} at {n}",
                       lambda st=staged, m=mesh: [decode_bits_striped(s, m)
                                                  for s in st],
                       [cache], 2, 2, [host_exact(b) for b in blobs], 0))
    pair = make_mesh({"data": 2, "stripe": 2}, mesh_devices(4))
    towers = [requantized(data["tower_420.jpg"], 5 * k) for k in range(16)]
    tower = [jt.stage_host_bits(b) for b in towers[:4]]
    tower_refs = [host_exact(b) for b in towers]
    routes.append(("DP x SP 4 x tower_420 on data 2 stripe 2",
                   lambda: decode_bits_striped_batch(tower, pair),
                   [cache], 2, 4, [np.stack(tower_refs[:4])], 0))
    data_mesh = make_mesh({"data": MESH_SLOTS}, mesh_devices(MESH_SLOTS))
    sof3 = [sof3_jpeg(sof3_samples(*SOF3_SLICE, 1, 16, 0, seed=k), 6, 0, 16)
            for k in range(8)]
    for label, opts, blobs, refs, tol in (
            ("tower_420 x16 on data 4", {}, towers, tower_refs, PIXEL_TOL),
            ("prefix tower_420 x8 on data 4", {"interchange": "prefix"},
             towers[:8], tower_refs[:8], PIXEL_TOL),
            ("SOF3 512x512 x8 predictor 6 on data 4", {}, sof3,
             [host_exact(b) for b in sof3], 0)):
        dec = jt.DeviceStreamDecoder(mesh=data_mesh, host_threads=1, **opts)
        group = [dec.stage(b) for b in blobs]
        kind = "lossless" if blobs is sof3 else \
            "prefix" if opts else "bits"
        routes.append((label, lambda d=dec, g=group, k=kind:
                       d._decode_group_mesh(k, g), [dec._graphs],
                       MESH_SLOTS, len(blobs), refs, tol))
    geometry, stores, qts = _host_stage(data["tower_420.jpg"])
    exact = dataclasses.replace(geometry, precision="exact")
    tol = PIXEL_TOL if geometry.precision == "fast" else 0

    def shifted(k: int) -> list:
        """tower_420's stores with every DC moved by 6 k."""
        out = [s.copy() for s in stores]
        for s in out:
            s[:, 0] += 6 * k
        return out
    shifts = [shifted(k) for k in range(8)]
    shift_refs = [host_recon(exact, st, qts) for st in shifts]
    batched = tuple(np.stack([st[c] for st in shifts])
                    for c in range(len(stores)))
    pipeline = make_batch_pipeline(geometry, data_mesh)
    routes.append(("decode_batch_sharded tower_420 x8 on data 4",
                   lambda: pipeline(batched, qts), [cache], MESH_SLOTS, 8,
                   [np.stack(shift_refs[k:k + 2]) for k in range(0, 8, 2)],
                   tol))
    d = jt.host.decoder.Decoder(data["tower_420.jpg"], backend="numpy")
    d._decode_entropy_only()
    rows = d.frame.mcu_size.height
    stripe_mesh = make_mesh({"stripe": 4}, mesh_devices(4))
    striped = make_stripe_pipeline(geometry, rows, 4, stripe_mesh)
    padded = [_pad_rows(geometry, shifts[k], rows, 4, False) for k in (0, 3)]
    routes.append(("make_stripe_pipeline tower_420 at 4",
                   lambda: [striped(p, tuple(qts)) for p in padded],
                   [cache], 2, 2,
                   [host_recon(exact, shifts[k], qts) for k in (0, 3)],
                   0))
    for precision in ("fast", "exact"):
        blobs = [requantized(data["large_420.jpg"], step) for step in (0, 7)]
        fronts = [_front_stores(b, precision) for b in blobs]
        routes.append((f"Decoder large_420 {precision}",
                       lambda f=fronts: [port_decoder.reconstruct_tensor(
                           g, st, q, dev) for g, st, q in f],
                       [cache], 2, 2, [host_exact(b) for b in blobs],
                       PIXEL_TOL if precision == "fast" else 0))
    return routes


def host_recon(geometry, stores, qts) -> np.ndarray:
    """The host's reconstruction of stores ([n_c, 64] each) at the
    geometry's precision."""
    from jpeg_decoder_tpu_torch.host.ops.pipeline import reconstruct_image

    return reconstruct_image(geometry, stores, qts)


def held_to_refs(label: str, outs: list, refs: list, tol: int) -> int:
    """Each output of a route against its own host decode (`refs`, in
    order; the output cropped to the reference's extent, as padded rows
    and columns are): the largest |difference|; raises past `tol` or on
    a count that differs."""
    if len(outs) != len(refs):
        raise AssertionError(f"28 {label}: {len(outs)} outputs, "
                             f"{len(refs)} references")
    worst = 0
    for i, (o, ref) in enumerate(zip(outs, refs)):
        got = o.cpu().numpy()
        got = got[tuple(slice(0, n) for n in ref.shape)]
        if got.shape != ref.shape:
            raise AssertionError(f"28 {label}: output {i} {got.shape}, its "
                                 f"reference {ref.shape}")
        err = int(np.abs(got.astype(np.int64) - ref.astype(np.int64)).max())
        if err > tol:
            raise AssertionError(f"28 {label}: output {i} differs from its "
                                 f"own host decode by {err} > {tol}")
        worst = max(worst, err)
    return worst


def _front_stores(blob: bytes, precision: str, scale: int = 1) -> tuple:
    """(geometry, stores, tables) of `blob` as `Decoder(precision=)` hands
    them to its device reconstruction, at 1/`scale` of its size."""
    from jpeg_decoder_tpu_torch.host.decoder import Decoder
    from jpeg_decoder_tpu_torch.host.ops.pipeline import geometry_from_frame

    d = Decoder(blob, backend="numpy", precision=precision)
    if scale > 1:
        probe = Decoder(blob, backend="numpy")
        probe.read_info()
        info = probe.info()
        d.scale(-(-info.width // scale), -(-info.height // scale))
    d._decode_entropy_only()
    n = len(d.frame.components)
    transform = None if n == 1 else d._determine_color_transform()
    return (geometry_from_frame(d.frame, transform, precision=precision),
            [d._pending_render[i][0].reshape(-1, 64) for i in range(n)],
            [d._pending_render[i][1] for i in range(n)])


def _stats(caches) -> dict:
    out = {"graphs": 0, "captures": 0, "hits": 0, "eager": 0}
    for cache in caches:
        for k, v in cache.stats().items():
            out[k] += v
    return out


def phase_mesh_graphs(jt, data: dict, card: str) -> dict:
    """28, the mesh and `Decoder` (`mesh_graph_routes`): per route two
    calls (the keys' first sight and their capture; a route of several
    data shards or lines captures at its second run), three replayed calls
    and one eager (`eager_bodies`) on the same staged inputs, SHA-256-equal
    output for output, and every output within the route's tolerance of
    its own image's host decode (each shard, line and run decodes an
    image of its own, of the route's keys); the replays' launches by `LAUNCHES` and their
    exchanged bytes by kind (`mesh.EXCHANGED`) equal to the eager call's;
    one capture a key and a replay per run from the third call on; each
    kernel by name as often over replayed as over eager calls
    (`kernels_gate`, behind the spin fill) and the `LAUNCHES` kernels by
    `replay_gate`; three calls under `set_sync_debug_mode("error")`, all
    replays. Measured: device and host ms per image and the idle share,
    replayed against eager; each graph's pool; the memory a route's graphs
    hold. `Decoder` on large_420 at fast and exact through its entry
    point (exact bit-equal to the host decode, fast within 3), its stage
    split; the Decoder's cache filled to its bound with the fixtures'
    geometries: its pools and the peak memory."""
    from jpeg_decoder_tpu_torch.parallel import mesh as mesh_mod

    out = {}
    dev = torch.device("cuda", torch.cuda.current_device())
    for label, call, caches, runs, images, refs, tol in mesh_graph_routes(
            jt, data, dev):
        torch.cuda.synchronize()
        base = _stats(caches)
        held = torch.cuda.memory_allocated()
        firsts = [_flat(call()) for _ in range(2)]
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - held
        after = _stats(caches)
        keys = after["graphs"] - base["graphs"]
        jt.reset_launches()
        mesh_mod.reset_exchanged()
        replays = [_flat(call()) for _ in range(3)]
        torch.cuda.synchronize()
        replayed = {k: v / 3 for k, v in jt.LAUNCHES.items() if v}
        moved = {k: v / 3 for k, v in mesh_mod.EXCHANGED.items()}
        hits = _stats(caches)["hits"] - after["hits"]
        jt.reset_launches()
        mesh_mod.reset_exchanged()
        with eager_bodies():
            body = _flat(call())
        torch.cuda.synchronize()
        eager_calls = {k: v for k, v in jt.LAUNCHES.items() if v}
        eager_moved = dict(mesh_mod.EXCHANGED)
        want = [_digest([t]) for t in body]
        err = max(held_to_refs(label, o, refs, tol)
                  for o in firsts + replays + [body])
        if any([_digest([t]) for t in o] != want for o in firsts + replays) \
                or replayed != eager_calls or moved != eager_moved \
                or keys < 1 or after["captures"] - base["captures"] != keys \
                or hits != 3 * runs:
            raise AssertionError(
                f"28 {label}: replay against eager: {replayed} {eager_calls} "
                f"exchanged {moved} {eager_moved} keys {keys} hits {hits}")
        counted, _ops, traces = replay_gate(label, call, eager_calls)

        def eager(call=call):
            with eager_bodies():
                return call()
        kernels, pairs = kernels_gate(label, call, eager)
        torch.cuda.synchronize()
        before = _stats(caches)["hits"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if _stats(caches)["hits"] - before != 3 * runs:
            raise AssertionError(f"28 {label}: the sync-free calls were not "
                                 "replays")
        by_name: dict = {}
        for op, n in kernels.items():
            by_name[kernel_name(op)] = \
                by_name.get(kernel_name(op), 0) + n / GRAPH_PROFILED
        iters = 20
        timed = {"replay": {**resident(call, iters, images),
                            **idle_share(call, iters, images)},
                 "eager": {**resident(eager, iters, images),
                           **idle_share(eager, iters, images)}}
        pools = [graph_pool_bytes(g) for c in caches
                 for g in c._graphs.values() if g.graph is not None]
        out[label] = {
            "sha256": _digest(body), "max_abs_err_own_host_decode": err,
            "keys": keys, "runs_per_call": runs,
            "launches_per_call": replayed, "exchanged_per_call": moved,
            "profiler_kernels_per_call": {
                k: v / GRAPH_PROFILED for k, v in counted.items() if v},
            "kernels_per_call": by_name, "profiler_traces": traces,
            "kernels_gate_pairs": pairs, "sync_free_calls": 3,
            "times": timed, "pool_bytes": pools,
            "memory_growth_first_two_calls": grown}
    say("28 mesh and Decoder graphs", card=card, **out)
    out["Decoder"] = front_end_graphs(jt, data, card)
    return out


def front_end_graphs(jt, data: dict, card: str) -> dict:
    """28, `Decoder` through its entry point on large_420 at fast and exact
    (exact bit-equal to the host's exact decode, fast within PIXEL_TOL; the
    third call on replays its recon key), ms/image split by stage (median
    of 5, host clock) replayed and with the eager body; then the cache
    cleared and filled past its bound with the fixtures' geometries at
    both precisions and four scales (each key's first sight, capture and a
    replay): its graphs, the sum of their pools and the peak memory
    allocated while it fills."""
    from jpeg_decoder_tpu_torch import decoder as port_decoder
    from jpeg_decoder_tpu_torch.models import graphs

    dev = torch.device("cuda", torch.cuda.current_device())
    cache = graphs.device_graphs(dev)
    large = data["large_420.jpg"]
    gold = host_exact(large)
    split = {}
    for precision in ("fast", "exact"):
        hits = cache.hits
        for _ in range(3):
            px = jt.Decoder(large, precision=precision).decode_array()
        err = int(np.abs(px.astype(np.int32) - gold.astype(np.int32)).max())
        if err > (PIXEL_TOL if precision == "fast" else 0) \
                or cache.hits == hits:
            raise AssertionError(f"28 Decoder {precision}: max |diff| {err},"
                                 f" replays {cache.hits - hits}")
        times = _split_ms(lambda timer: jt.Decoder(
            large, precision=precision, timer=timer).decode_array())
        with eager_bodies():
            eager = _split_ms(lambda timer: jt.Decoder(
                large, precision=precision, timer=timer).decode_array())
        split[precision] = {"max_abs_err": err, "replay": times,
                            "eager": eager}
    cache.clear()
    captures = cache.captures
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    filled = 0
    for name in reversed(ORDER):    # large_420's keys the last in the LRU
        for precision in ("fast", "exact"):
            for scale in (1, 2, 4, 8):
                g, st, q = _front_stores(data[name], precision, scale)
                for _ in range(3):
                    port_decoder.reconstruct_tensor(g, st, q, dev)
                filled += 1
    torch.cuda.synchronize()
    pools = [graph_pool_bytes(g) for g in cache._graphs.values()
             if g.graph is not None]
    full = {"keys_called": filled, "graphs": len(cache),
            "captures": cache.captures - captures, "pool_bytes_sum": sum(
                p for p in pools if p), "pool_bytes_max": max(
                (p for p in pools if p), default=None),
            "allocated_growth_bytes": torch.cuda.memory_allocated() - held,
            "peak_allocated_growth_bytes":
                torch.cuda.max_memory_allocated() - held}
    say("28 Decoder graphs", card=card, split=split, cache_full=full)
    return {"split": split, "cache_full": full}


def phase_graphs(jt, data: dict, card: str) -> dict:
    """28. The compiled dispatch (`models/graphs.py`): the bits, prefix and
    lossless device halves captured once per key as CUDA graphs and
    replayed. Every route of GRAPH_ROUTES: the key's first call (eager,
    off any graph), three calls on freshly landed inputs (the warm-up and
    the capture, then two replays) and the eager body on the same inputs
    SHA-256-equal; each replay counting the eager body's launches, by
    kernel; one capture and two replays per key; on the prefix and
    lossless routes every kernel by name, PyTorch's included, as often
    over replays as over eager bodies (`kernels_gate`) and three replays
    under `torch.cuda.set_sync_debug_mode("error")`. tower_420, tower_420_q92 and
    optimized/tower_420_opt.jpg alternating on one decoder (the first and
    the last share one key and one graph): every image SHA-256-equal to
    its eager body's, and every tensor handed out unchanged after the
    later replays. GRAPH_REPLAYS replays of tower_420's graph, every output
    equal to the first; a group of 4 large_420 (U1 and A1 over several
    tiles) replayed across the end of its device epochs. Replays of warmed
    keys under `torch.cuda.set_sync_debug_mode("error")`. Launches per
    image by `_build.LAUNCHES`, and by the profiler on every route: each
    kernel of the eager body exactly as often in GRAPH_PROFILED replays,
    or the phase fails; captures, replays and each graph's pool (the
    allocator's segments of it) and peak memory. Times, eager body beside replay in this run
    (GRAPH_TIMED), on inputs landed once and landing them every call:
    device ms/image, host ms/image and the card's idle share, and
    `device_resident_rate`; each eager wrapper's host µs beside its
    kernel's device µs (`wrapper_host_us`). The hetero groups: a sweep
    graph and a graph per part (`phase_hetero_graphs`)."""
    routes, timed, memory = {}, {}, {}
    for label, opts, source, batch in GRAPH_ROUTES:
        blob = route_blob(data, source)
        with jt.DeviceStreamDecoder(host_threads=1, **opts) as dec:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            calls = graph_calls(dec, blob, batch)   # the key's first call
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
            replay, eager = calls["replay_landed"], calls["eager_landed"]
            first = calls["first"]
            reserved = torch.cuda.memory_reserved()
            jt.reset_launches()
            replays = [replay() for _ in range(3)]  # the first captures
            torch.cuda.synchronize()
            reserved = torch.cuda.memory_reserved() - reserved
            replayed = {k: v / 3 / batch for k, v in jt.LAUNCHES.items() if v}
            jt.reset_launches()
            body = eager()
            torch.cuda.synchronize()
            eager_calls = {k: v for k, v in jt.LAUNCHES.items() if v}
            eager_launches = {k: v / batch for k, v in eager_calls.items()}
            stats = dec._graphs.stats()
            want = _digest([body])
            if any(_digest([t]) != want for t in [first] + replays) \
                    or replayed != eager_launches \
                    or stats["captures"] != 1 or stats["hits"] != 2:
                raise AssertionError(f"28 {label}: replay against eager: "
                                     f"{replayed} {eager_launches} {stats}")
            # The replays' kernels as the profiler sees them: each kernel
            # of the eager body exactly as often a replay, no other.
            counted, ops, traces = replay_gate(label, replay, eager_calls)
            if calls["kind"] != "bits":
                kernels, pairs = kernels_gate(label, replay, eager)
                by_name: dict = {}
                for op, n in kernels.items():
                    by_name[kernel_name(op)] = \
                        by_name.get(kernel_name(op), 0) + n / GRAPH_PROFILED
                extra = {"kernels_per_call": by_name,
                         "kernels_gate_pairs": pairs,
                         "sync_free_replays": sync_free_replays(label, dec,
                                                                replay)}
            else:
                extra = {}
            routes[label] = {**extra,
                "profiler_traces": traces,
                "sha256": want, "launches_per_image": replayed,
                "profiler_kernels_per_image": {
                    k: v / GRAPH_PROFILED / batch
                    for k, v in counted.items() if v},
                "profiler_ops_per_call": {
                    op.split("(")[0].split("::")[-1]: n / GRAPH_PROFILED
                    for op, n in ops.items()},
                "graph": stats}
            memory[label] = {"pool_bytes": graph_pool_bytes(
                                 calls["fill"].graph),
                             "reserved_growth_capture_3_replays": reserved,
                             "peak_bytes_first_call": peak,
                             "arena_bytes": calls["fill"].graph.arena
                             .numel()}
            if label in GRAPH_TIMED:
                iters = 50 if batch == 1 else 10
                timed[label] = {
                    mode: {**resident(calls[mode], iters, batch),
                           **idle_share(calls[mode], iters, batch)}
                    for mode in ("eager", "replay", "eager_landed",
                                 "replay_landed")}
                timed[label]["device_resident_rate"] = \
                    dec.device_resident_rate(blob, iters=iters, batch=batch)
    say("28 replay equals eager", **routes)
    say("28 memory", **memory)

    # One key through three images, and tensors handed out earlier.
    names = ("tower_420.jpg", "tower_420_q92.jpg",
             "optimized/tower_420_opt.jpg")
    blobs = [(FIXTURES / n).read_bytes() for n in names]
    with jt.DeviceStreamDecoder(host_threads=1) as dec:
        want = []
        for blob in blobs:
            st = dec.stage(blob)
            want.append(_digest([dec._run_device_eager(
                st, dec._to_device(st))]))
        outs = dec.decode_stream(blobs * 4)
        torch.cuda.synchronize()
        got = [_digest([o]) for o in outs]
        keys = len(dec._graphs)
        hits = dec._graphs.hits
        later = dec.decode_stream(blobs * 2)
        torch.cuda.synchronize()
        kept = [_digest([o]) for o in outs]
    if got != want * 4 or kept != got or keys != 2 \
            or [_digest([o]) for o in later] != want * 2:
        raise AssertionError(f"28 one key through three images: {keys} "
                             "graphs, or an output differs")
    alternating = {"graphs": keys, "replays": hits,
                   "shared_key": [names[0], names[2]]}

    # GRAPH_REPLAYS replays of one graph; the epochs' wrap.
    with jt.DeviceStreamDecoder(host_threads=1) as dec:
        replay = graph_calls(dec, data["tower_420.jpg"], 1)["replay_landed"]
        ref = replay()          # the warm-up and the capture
        bad = torch.zeros((), dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for _ in range(GRAPH_REPLAYS):
            bad += (replay() != ref).sum()
        torch.cuda.synchronize()
        many_s = time.perf_counter() - t0
        grew = torch.cuda.memory_allocated() - held
        many = {"replays": dec._graphs.hits, "differing_bytes": int(bad),
                "seconds": many_s, "memory_growth_bytes": grew}
    if many["differing_bytes"] or many["replays"] < GRAPH_REPLAYS:
        raise AssertionError(f"28 {GRAPH_REPLAYS} replays: {many}")
    with jt.DeviceStreamDecoder(host_threads=1) as dec:
        calls = graph_calls(dec, data["large_420.jpg"], 4)
        replay, fill = calls["replay_landed"], calls["fill"]
        ref = replay()
        replay()
        bufs = fill.graph.scope.epochs.buffers
        ends = {"assemble": 1 << 32, "unpack_delta": 1 << 30}
        for kernel, end in ends.items():
            w = (end - 2) << 32
            bufs[kernel][0][0] = w - (1 << 64) if w >= 1 << 63 else w
        outs = [replay() for _ in range(4)]
        torch.cuda.synchronize()
        epochs = {k: int(b[0][0]) >> 32 for k, b in bufs.items()}
    if set(bufs) != set(ends) or epochs != {k: 2 for k in ends} \
            or any(not torch.equal(o, ref) for o in outs):
        raise AssertionError(f"28 the epochs' wrap: {epochs}")

    # No synchronisation on a replay of a warmed key, through the
    # decoder's own entry points.
    with jt.DeviceStreamDecoder(host_threads=1) as dec:
        one = dec.stage(data["large_420.jpg"])
        group = [dec.stage(data["tower_420.jpg"])] * 16

        def calls():
            return (dec._run_device(one, dec._to_device(one)),
                    dec._run_group("bits", group,
                                   dec._group_wires("bits", group)))
        calls()                 # the keys' first sight
        calls()                 # their capture
        torch.cuda.synchronize()
        hits = dec._graphs.hits
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(5):
                calls()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if dec._graphs.hits - hits != 10:
            raise AssertionError("28 the sync-free calls were not replays")

    hetero = phase_hetero_graphs(jt, card)
    mesh = phase_mesh_graphs(jt, data, card)
    wrappers = wrapper_host_us(jt, data)
    say("28 graphs", card=card, alternating=alternating, many_replays=many,
        wrap_epochs=epochs, sync_free_replays="ok", times=timed,
        wrappers=wrappers)
    return {"routes": routes, "memory": memory, "times": timed,
            "wrappers": wrappers, "many": many, "hetero": hetero,
            "mesh": mesh}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import jpeg_decoder_tpu_torch as jt
    from jpeg_decoder_tpu_torch import _build
    from jpeg_decoder_tpu_torch.entropy.assemble import assemble_nat
    from jpeg_decoder_tpu_torch.entropy.chunk_decode import (
        decode_chunks, decode_chunks_plain, unpack_delta)
    from jpeg_decoder_tpu_torch.host.decoder import Decoder
    from jpeg_decoder_tpu_torch.host.entropy.native import get_native
    from jpeg_decoder_tpu_torch.host.ops.tail import (_TAIL_TRANSFORMS,
                                                      pallas_tail_mode)
    from jpeg_decoder_tpu_torch.ops.kernels import (dequant_idct,
                                                    dequant_idct_plain,
                                                    fused_recon,
                                                    fused_recon_plain,
                                                    fused_tail,
                                                    fused_tail_plain,
                                                    idct_exact_batch,
                                                    interleaved_tail)
    from jpeg_decoder_tpu_torch.ops.pipeline import _planes, fast_pixels
    from jpeg_decoder_tpu_torch.params import DeviceParams
    from tools.experiments import fused_recon_probe_torch as k4_probe
    from tools.torch_port_profile import profile as profile_layers

    dev = torch.device("cuda")
    sys.path.insert(0, str(ROOT / "tests"))    # torch_inputs: input recipes
    card = card_line()
    say("1 card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        native_host_library=get_native() is not None)
    if get_native() is None:
        raise AssertionError("1: the native host library is not engaged: "
                             "its g++ build failed or JPEG_TPU_DISABLE_NATIVE "
                             "is set")

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
            ab, base = unpack_delta(dm)
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
        if min(launches["huffman_decode"], launches["dequant_idct"],
               launches["interleaved_tail"], launches["assemble"],
               launches["unpack_delta"]) < 1:
            raise AssertionError(f"a kernel of the path never ran: {launches}")
        isolated = dec.decode_stream(
            [data["small_444.jpg"], BAD_JPEG, data["small_444.jpg"]],
            on_error="none")
        torch.cuda.synchronize()
        if isolated[1] is not None or not all(
                isinstance(img, torch.Tensor) and img.is_cuda
                for img in (isolated[0], isolated[2])):
            raise AssertionError("on_error='none' must give [image, None, "
                                 f"image], got {[type(x) for x in isolated]}")
        say("5 slice", images=len(images), launches=launches,
            max_abs_diff_vs_exact=worst, tolerance=PIXEL_TOL,
            on_error_none=["cuda tensor", None, "cuda tensor"])

        # 6. Times.
        rates = {name: dec.device_resident_rate(data[name], iters=50)
                 for name in ("large_420.jpg", "tower_420.jpg")}
    say("6 device_resident_rate", **rates)

    args1 = k1_inputs["large_420.jpg"]
    k1_ms = cuda_ms(lambda: decode_chunks(*args1), 50)
    k1_plain_ms = cuda_ms(lambda: decode_chunks_plain(*args1), 3)
    renders = oracle("large_420.jpg")._pending_render
    geometry2 = staged["large_420.jpg"].geometry
    stores2 = [torch.from_numpy(renders[i][0].reshape(-1, 64)).to(dev)
               for i in range(len(renders))]
    qts2 = [renders[i][1] for i in range(len(renders))]
    scales2 = [c.dct_scale for c in geometry2.components]

    def k2_image():
        return fast_pixels(geometry2, stores2, qts2, params)

    def k2_image_plain():
        return [dequant_idct_plain(s, params.qt(q), params.basis(k), k)
                for s, q, k in zip(stores2, qts2, scales2)]

    k2_ms = cuda_ms(k2_image, 50)
    k2_plain_ms = cuda_ms(k2_image_plain, 50)
    # The yardstick: one PyTorch call for the same product, fp32 coefficients
    # of every block against luma's basis with q folded in, plus 128.5.
    coef_f32 = torch.cat(stores2).to(torch.float32)
    folded = params.qt(qts2[0])[:, None] * params.basis(8)
    bias = torch.full((1, 64), 128.5, device=dev)
    def k2_library():
        return torch.addmm(bias, coef_f32, folded)

    k2_library_ms = cuda_ms(k2_library, 50)
    k2_blocks = [int(s.shape[0]) for s in stores2]
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
        k2_blocks=k2_blocks, k2_ms=k2_ms, k2_plain_ms=k2_plain_ms,
        k2_library_ms=k2_library_ms)
    say("6 host staging ms/image", **stage_ms)

    # 7. K3 against its plain version: every fixture geometry it takes
    # (planes from the oracle's stores through K2), then seeded planes.
    def fixture_planes(name):
        renders = oracle(name)._pending_render
        geometry = staged[name].geometry
        planes = [p[0] for p in _planes(
            geometry,
            [torch.from_numpy(renders[i][0].reshape(1, -1, 64)).to(dev)
             for i in range(len(renders))],
            [tuple(renders[i][1] for i in range(len(renders)))], params)]
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
    k3_cases += odd_tail_cases(rng, dev)
    k3_err = 0
    for planes, (modes, transform, out_h, out_w, chroma) in k3_cases:
        args3 = (planes, modes, chroma, transform, out_h, out_w)
        a = fused_tail(*args3)
        b = fused_tail_plain(*args3)
        if a.shape != (len(planes), out_h, out_w):
            raise AssertionError(f"K3 shape {tuple(a.shape)}")
        err = int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
        if err:
            raise AssertionError(f"K3 differs from plain by {err} at {modes} "
                                 f"{transform} {out_h}x{out_w}, pitches "
                                 f"{[p.stride(0) for p in planes]}")
        k3_err = max(k3_err, err)
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
        if res["k4_vs_x_max_abs_diff"] > K4_X_TOL \
                or res["k4_vs_plain_max_abs_diff"] > K4_TOL:
            raise AssertionError(f"K4 {res['case']}: vs K2 path "
                                 f"{res['k4_vs_x_max_abs_diff']}, vs plain "
                                 f"{res['k4_vs_plain_max_abs_diff']}")
    if k4_launches < 1:
        raise AssertionError("K4 never ran in the probe")
    k4_err = max(res["k4_vs_plain_max_abs_diff"] for res in k4_results)
    k4_x_err = max(res["k4_vs_x_max_abs_diff"] for res in k4_results)
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

    # 11-15. The rest of the one-image decoder; from 14 on, every P1 and D1
    # call is checked against its plain version (phase 26).
    exact_launches = phase_exact(jt, data, profile_layers)
    k1_err = max(k1_err, phase_transcoded(jt, data, params, dev))
    k1_err = max(k1_err, phase_three_pairs(jt, data, params, dev))
    p1d1 = P1D1Calls()
    p1d1.install()
    prefix_launches = phase_prefix(jt, data)
    p1d1.check("14 prefix")
    l1_launches, l1_err, l1_ms, l1_plain_ms, l1_call, l1_samples, l1_chain = \
        phase_lossless(jt, dev)

    # 16. The kernel table: device time by kernel name beside the bound.
    main_launches = main_path_launches(jt, data["large_420.jpg"])
    exact_main = main_path_launches(jt, data["large_420.jpg"], "exact")
    e1_tables = [[params.qt_exact(q)] for q in qts2]

    def e1_image():
        return idct_exact_batch([s[None] for s in stores2], e1_tables,
                                scales2)

    from torch_inputs import t1_args
    t1_pixels2 = [p[None] for p in k2_image()]
    t1_args2 = t1_args(geometry2)
    t1_bytes = (sum(p.numel() for p in t1_pixels2)
                + len(t1_pixels2) * t1_args2[2] * t1_args2[3])

    k4_args = k4_probe.case_args(k4_probe.seeded_stores(0),
                                 k4_probe.image_stores(
                                     (FIXTURES / "small_444.jpg")
                                     .read_bytes())[1],
                                 k4_probe.LARGE_BLOCKS[1] * 8)
    k4_blocks = 3 * k4_args[0].shape[0] * k4_args[0].shape[1]
    k1_bytes = 4 * sum(a.numel() for a in args1[:4]) + 128 * args1[6]
    k2_px = sum(n * k * k for n, k in zip(k2_blocks, scales2))
    if exact_main["interleaved_tail"] != 1 or exact_main["assemble"] != 1 \
            or exact_main["unpack_delta"] != 1:
        raise AssertionError(f"16 T1, A1 and U1 at exact: {exact_main}")
    a1_plan = staged["large_420.jpg"].scans[0].scan.plan
    a1_nat = decode_chunks(*args1)
    a1_stores = assemble_nat(a1_nat, a1_plan)
    table = phase_kernel_table(jt, {
        "K1": (lambda: decode_chunks(*args1), "huffman_decode_kernel",
               k1_bytes, 0.0, FP32_FLOPS),
        "K2": (k2_image, "dequant_idct_kernel",
               128 * sum(k2_blocks) + k2_px, 3 * 2 * 64 * k2_px, TF32_FLOPS),
        "K3": (lambda: fused_tail(*args3), "fused_tail_kernel",
               sum(p.numel() for p in planes3) + len(planes3) * h3 * w3,
               0.0, FP32_FLOPS),
        "K4": (lambda: fused_recon(*k4_args), "fused_recon_kernel",
               128 * k4_blocks + 64 * k4_blocks, 3 * 2 * 64 * 64 * k4_blocks,
               TF32_FLOPS),
        "L1": (l1_call, "lossless_recur_kernel", 8 * l1_samples, 0.0,
               FP32_FLOPS),
        "E1": (e1_image, "idct_exact_kernel", 128 * sum(k2_blocks) + k2_px,
               E1_OPS_PER_BLOCK * sum(k2_blocks), INT32_OPS),
        "T1": (lambda: interleaved_tail(t1_pixels2, *t1_args2),
               "interleaved_tail_kernel", t1_bytes, 0.0, FP32_FLOPS),
        "A1": (lambda: assemble_nat(a1_nat, a1_plan), "assemble_kernel",
               2 * a1_nat.numel() + 2 * sum(t.numel() for t in a1_stores),
               0.0, FP32_FLOPS),
        "U1": (lambda: unpack_delta(args1[1]), "unpack_delta_kernel",
               12 * args1[1].numel(), 0.0, FP32_FLOPS),
    }, {**dict(zip(("K1", "K2", "K3", "K4", "L1"),
                   (main_launches[k] for k in _build.LAUNCHES))),
        "E1": exact_main["idct_exact"],
        "T1": main_launches["interleaved_tail"],
        "A1": main_launches["assemble"],
        "U1": main_launches["unpack_delta"]}, l1_chain,
        {"K2": ("library", k2_library),
         "K4": ("unfused", lambda: fused_recon_plain(*k4_args,
                                                     k2=dequant_idct))})

    # 17. Batched dispatch.
    phase_batch(jt, data, params, dev, profile_layers)
    p1d1.check("17 batches")

    # 18. The front end and the service.
    front = phase_front_end(jt, data, dev)

    # 19. The mesh.
    mesh = phase_mesh(jt, data, params, dev, card)
    k1_err = max(k1_err, mesh["k1_err"])
    p1d1.check("19 mesh")

    # 20. The mesh across two processes.
    multiproc = phase_multiproc(jt, card, mesh["striped_8_ms"])

    # 21. The mutation fuzzer on the card; 22. the sweep and the CLI.
    fuzz = phase_fuzz(jt, card)
    p1d1.check("21 fuzz")
    phase_tools(jt, card)
    p1d1.check("22 tools")
    p1d1.remove()

    # 23. E1 against its plain version, its segment table, its times.
    e1 = phase_e1(jt, data, params, dev, card)

    # 24. T1 against its plain version on real and seeded calls, its times.
    t1 = phase_t1(jt, data, params, dev, card)

    # 25. A1 and U1 against their plain versions, their times.
    a1u1 = phase_a1_u1(jt, data, params, dev, card)

    # 26. P1 and D1 against their plain versions, their times.
    p1d1_res = phase_p1_d1(jt, data, params, dev, card, p1d1)

    # 27. The main path along the host switches, a subprocess per leg.
    matrix = phase_matrix(jt, card)

    # 28. The compiled dispatch: one CUDA graph per key, replayed.
    phase_graphs(jt, data, card)

    loaded = sorted(m for m in sys.modules if m.split(".")[0]
                    in ("jax", "jaxlib", "jpeg_decoder_tpu"))
    if loaded:
        raise AssertionError(f"the run imported {loaded[:5]}")
    kernels = [
        {"name": "K1 huffman_decode", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/huffman_decode.cu",
         "replaces": "jpeg_decoder_tpu/entropy/pallas_decode.py:773",
         "launches": launches["huffman_decode"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "library_ms": None},
        {"name": "K2 dequant_idct", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/dequant_idct.cu",
         "replaces": "jpeg_decoder_tpu/ops/pallas_kernels.py:26",
         "launches": launches["dequant_idct"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "library_ms": k2_library_ms},
        {"name": "K3 fused_tail", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/fused_tail.cu",
         "replaces": "jpeg_decoder_tpu/ops/pallas_kernels.py:80",
         "launches": planar_launches["planar-pallas"]["fused_tail"],
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
         "library_ms": None},
        {"name": "K4 fused_recon", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/fused_recon.cu",
         "replaces": "tools/experiments/fused_recon_probe.py:60",
         "launches": k4_launches, "max_abs_err": k4_err,
         "ms": k4_large["k4_ms"], "plain_ms": k4_large["plain_ms"],
         "library_ms": None},
        {"name": "L1 lossless_recur", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/lossless_recur.cu",
         "replaces": "jpeg_decoder_tpu/ops/predictors.py:273",
         "launches": l1_launches, "max_abs_err": l1_err,
         "ms": l1_ms, "plain_ms": l1_plain_ms, "library_ms": None},
        {"name": "E1 idct_exact", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/idct_exact.cu",
         "replaces": "jpeg_decoder_tpu/ops/idct.py:210",
         "launches": exact_launches["idct_exact"],
         "max_abs_err": e1["max_abs_err"], "ms": e1["ms"],
         "plain_ms": e1["plain_ms"], "library_ms": None},
        {"name": "T1 interleaved_tail", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/interleaved_tail.cu",
         "replaces": "jpeg_decoder_tpu/ops/pipeline.py:92",
         "launches": launches["interleaved_tail"],
         "max_abs_err": t1["max_abs_err"], "ms": t1["ms"],
         "plain_ms": t1["plain_ms"], "library_ms": None},
        {"name": "A1 assemble", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/assemble.cu",
         "replaces": "jpeg_decoder_tpu/entropy/device_scan.py:914",
         "launches": launches["assemble"],
         "max_abs_err": a1u1["max_abs_err"], "ms": a1u1["a1_ms"],
         "plain_ms": a1u1["a1_plain_ms"], "library_ms": None},
        {"name": "U1 unpack_delta", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/unpack_delta.cu",
         "replaces": "jpeg_decoder_tpu/entropy/pallas_decode.py:658",
         "launches": launches["unpack_delta"],
         "max_abs_err": a1u1["max_abs_err"], "ms": a1u1["u1_ms"],
         "plain_ms": a1u1["u1_plain_ms"],
         "library_ms": a1u1["u1_library_ms"]},
        {"name": "P1 prefix_rebuild", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/prefix_rebuild.cu",
         "replaces": "jpeg_decoder_tpu/models/stream.py:92",
         "launches": prefix_launches["prefix_rebuild"],
         "max_abs_err": p1d1_res["max_abs_err"], "ms": p1d1_res["p1_ms"],
         "plain_ms": p1d1_res["p1_plain_ms"], "library_ms": None},
        {"name": "D1 dc_totals", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/dc_totals.cu",
         "replaces": "jpeg_decoder_tpu/entropy/device_scan.py:779",
         "launches": mesh["d1_stripe_launches"],
         "max_abs_err": p1d1_res["max_abs_err"], "ms": p1d1_res["d1_ms"],
         "plain_ms": p1d1_res["d1_plain_ms"],
         "library_ms": p1d1_res["d1_library_ms"]},
    ]
    for row, key in zip(kernels, ("K1", "K2", "K3", "K4", "L1", "E1", "T1",
                                  "A1", "U1")):
        tab = table[key]
        row.update(kernel_us=tab["kernel_us"], bound_us=tab["bound_us"],
                   bound_ms=tab["bound_us"] / 1e3, bound_by=tab["bound_by"],
                   launches_per_image=tab["launches_per_image"])
    kernels[0]["stripe_launches"] = mesh["stripe_launches"]
    for row, key in zip(kernels, _build.LAUNCHES):
        row["multiproc_launches"] = {f"rank {rank}": counts[key]
                                     for rank, counts in multiproc.items()}
    kernels[1]["library_device_us"] = table["K2"]["library_device_us"]
    kernels[1]["front_end_launches"] = front["K2"]
    kernels[4]["front_end_launches"] = front["L1"]
    kernels[3].update(
        max_abs_err_vs_k2_path=k4_x_err,
        unfused_device_us=table["K4"]["unfused_device_us"],
        unfused_launches_per_call=table["K4"]["unfused_launches_per_call"])
    kernels[4]["chain_bound_ms"] = table["L1"]["chain_bound_us"] / 1e3
    kernels[5].update(stripe_launches=mesh["e1_stripe_launches"],
                      front_end_launches=front["E1"],
                      fuzz_launches=fuzz["launches"]["idct_exact"])
    kernels[6].update(phase24_times=t1["times"],
                      stripe_launches=mesh["t1_stripe_launches"],
                      front_end_launches=front["T1"],
                      fuzz_launches=fuzz["launches"]["interleaved_tail"],
                      launches_per_image_exact=exact_main["interleaved_tail"])
    kernels[7].update(phase25_times={k: v for k, v in a1u1["times"].items()
                                     if k.startswith("A1")},
                      phase25_calls=a1u1["calls"],
                      stripe_launches=mesh["a1_stripe_launches"],
                      fuzz_launches=fuzz["launches"]["assemble"],
                      launches_per_image_exact=exact_main["assemble"])
    kernels[8].update(phase25_times={k: v for k, v in a1u1["times"].items()
                                     if k.startswith("U1")},
                      fuzz_launches=fuzz["launches"]["unpack_delta"],
                      launches_per_image_exact=exact_main["unpack_delta"])
    for row, key in ((kernels[9], "P1 large_420"),
                     (kernels[10], "D1 large_420 stripe 2 of 4")):
        tab = p1d1_res["times"][key]
        row.update(kernel_us=tab["kernel_us"], bound_us=tab["bound_us"],
                   bound_ms=tab["bound_us"] / 1e3, bound_by="bytes",
                   phase26_times=p1d1_res["times"],
                   phase26_calls=p1d1_res["calls"],
                   fuzz_launches=fuzz["launches"][
                       "prefix_rebuild" if key.startswith("P1")
                       else "dc_totals"])
    kernels[9].update(launches_per_image=2,
                      phase14_prefix_fast_interleaved=prefix_launches)
    kernels[10].update(launches_per_stripe=1,
                       mesh_launches_per_stripe=mesh["launches_per_stripe"])
    for row, key in zip(kernels, _build.LAUNCHES):
        ran = {leg: res["launches"][key] for leg, res in matrix.items()
               if leg != "default" and res["launches"][key]}
        if ran:
            row["matrix_launches"] = ran
    print(json.dumps({"matrix": {
        leg: {k: v for k, v in res.items() if k != "runs"}
        for leg, res in matrix.items()}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(matrix_leg() if sys.argv[1:] == ["--matrix-leg"] else main())

#!/usr/bin/env python
"""Mutation fuzzer for the PyTorch port, the counterpart of tools/fuzz.py.

Seeded random byte mutations of the port's seed corpus, decoded by
`jpeg_decoder_tpu_torch` (never JAX, never the JAX package). Three modes,
each the reference tool's, with its mutation operators and its exit rule
(nonzero when any mutant fails):

- host (`run`, tools/fuzz.py:117-271): the port's `Decoder(backend="numpy")`
  on the native engine (host/entropy/native.py), on the oracle engine
  (host/entropy/scan_python.py, selected by JPEG_TPU_DISABLE_NATIVE and
  `reset_native_cache()`) and streaming through a non-seekable reader must
  give the same bytes or raise the same `JpegError` class; any other
  exception, or a hang past the alarm, fails. Where PIL imports, its
  libjpeg decode is compared as the reference compares it (a shape
  disagreement fails; pixel differences on mutated streams are counted,
  not failed). Where PIL does not import, the PIL leg is skipped and the
  tool says so.
- device (`run_device`, tools/fuzz.py:274-401, widened to the port's
  paths): mutants that write 1-8 bytes after the first SOS header, in
  streams of 6 sources (about 70% mutated), through
  `DeviceStreamDecoder(device=...).decode_stream(..., on_error="none")` at
  batch_size 1 and 4 on one (interchange, precision) pair per stream, the
  pairs taken in turn (bits/prefix x fast/exact), and through
  `Decoder(backend="torch", device=...)` one source at a time. The
  reference outcome of each source is the port's host oracle,
  `Decoder(backend="numpy", precision="exact")` on the oracle engine, its
  stores from `_decode_entropy_only`. Invariants:
    1. only a typed JpegError, never another exception, never a hang; a
       source whose staging raises has None in its slot, and the oracle
       raises the same class;
    2. a scan the prescan accepts is one the oracle decodes ("PRESCAN
       ACCEPTED, ORACLE RAISED" otherwise);
    3. on every staged bits scan, K1's `nat` assembled is bit-equal to the
       oracle's stores (on "cuda" also K1 bit-equal to `decode_chunks_plain`
       run on the card on the same wire, and K1 launched once per scan);
    4. exact pixels and lossless samples bit-equal to the oracle, fast
       pixels within 3 of the oracle's exact pixels, every image of a
       batch bit-equal to its batch_size=1 decode, layout "planar-pallas"
       bit-equal to the interleaved image permuted;
    5. on "cuda", K3 (`fused_tail`) bit-equal to `fused_tail_plain` on the
       planes of every 4:2:0-class bits source, and L1 (`lossless_recur`)
       bit-equal to `lossless_recur_plain` on the differences of every
       lossless source at a predictor `ops.predictors.runs_l1` names.
  A fast-tier pixel beyond 3 whose exact decode and stores still agree bit
  for bit with the oracle is a miss of the fp32 product on garbage
  coefficients, not of the decode: it is counted apart ("fast misses"),
  saved, and reported with its largest dequantized coefficient; it does
  not fail the run. Any other fast miss fails.
- guided (`run_guided`, tools/fuzz.py:407-591): line coverage through
  `sys.monitoring` over jpeg_decoder_tpu_torch/host/, the oracle engine
  forced; the flat random scheduler and the coverage-guided one run the
  same budget and both curves go to a JSON file. Host only.

Seeds (the reference's seed paths are absent): tests/fixtures/torch_port/
*.jpg without large_420, large_420_progressive and stripe_420 (the Python
oracle takes about a second each on them; `--seeds` can still name them),
six lossless streams from tools/make_torch_fixtures.py::sof3_jpeg
(predictors 1, 6 and 7, 16-bit and 8-bit, at most 128 x 128) and
tests/torch_inputs.py::quirk_jpeg (the prescan's fallback). Failing
mutants are saved to --out (default: fuzz_torch/ in the temporary
directory) as the reference names them (fuzz_crash_<i>.jpg,
fuzz_dev_diff_<i>.jpg, ...).

Usage:
  python tools/fuzz_torch.py [iterations] [seed] [--device] [--guided]
      [--lean-seeds] [--torch-device cuda|cpu] [--seeds a.jpg,b.jpg]
      [--out DIR]

`--device` picks the device mode and `--guided` the guided mode, as in the
reference; `--torch-device` says where the port runs in device mode
("cuda", the default, or "cpu", where every kernel wrapper runs its plain
PyTorch version).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import random
import signal
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))    # torch_inputs: input recipes

# Left out of the default seeds for time (the oracle engine is Python).
SLOW_FIXTURES = ("large_420.jpg", "large_420_progressive.jpg",
                 "stripe_420.jpg")
# Lossless seeds: name -> (h, w, components, precision, pt, predictor,
# sample seed).
SOF3_SEEDS = {
    "sof3_p1_16.jpg": (96, 80, 1, 16, 0, 1, 11),
    "sof3_p1_8.jpg": (64, 72, 1, 8, 0, 1, 12),
    "sof3_p6_16.jpg": (80, 96, 1, 16, 0, 6, 13),
    "sof3_p6_8_rgb.jpg": (48, 64, 3, 8, 0, 6, 14),
    "sof3_p7_16_pt1.jpg": (128, 128, 1, 16, 1, 7, 15),
    "sof3_p7_8.jpg": (72, 56, 1, 8, 0, 7, 16),
}
LEAN_SEED = "small_gray.jpg"
STREAM_LEN = 6          # sources per decode_stream call
MUTATED_SHARE = 0.7     # share of a stream's sources that are mutants
BATCH = 4               # the batched decode of every stream
PIXEL_TOL = 3           # fast tier against the exact decode (reftest tolerance)
CAP = 64 << 20          # decode cap (set_max_decoding_buffer_size)
# Device mode: (interchange, precision) of stream k is PAIRS[k % 4].
PAIRS = (("bits", "fast"), ("bits", "exact"), ("prefix", "fast"),
         ("prefix", "exact"))


def default_out() -> str:
    return os.path.join(tempfile.gettempdir(), "fuzz_torch")


def seed_corpus(names=None) -> dict:
    """{name: bytes} of the seeds: `names` from the full set (every fixture,
    the SOF3 streams, "quirk.jpg"), or the default set."""
    from tools.make_torch_fixtures import sof3_jpeg, sof3_samples
    from torch_inputs import quirk_jpeg

    fixtures = sorted(p.name for p in FIXTURES.glob("*.jpg"))
    every = fixtures + list(SOF3_SEEDS) + ["quirk.jpg"]
    if names is None:
        names = [n for n in every if n not in SLOW_FIXTURES]
    unknown = sorted(set(names) - set(every))
    if unknown:
        raise ValueError(f"unknown seeds {unknown}; choose from {every}")
    out = {}
    for name in names:
        if name in SOF3_SEEDS:
            h, w, c, prec, pt, pred, s = SOF3_SEEDS[name]
            out[name] = sof3_jpeg(sof3_samples(h, w, c, prec, pt, seed=s),
                                  pred, pt, prec)
        elif name == "quirk.jpg":
            out[name] = quirk_jpeg(0)
        else:
            out[name] = (FIXTURES / name).read_bytes()
    return out


def mutate(data: bytes, rng: random.Random) -> bytes:
    """The reference's operators (tools/fuzz.py:54-69): 1-8 of byte flips,
    truncations and duplicated slices."""
    buf = bytearray(data)
    n_mut = rng.randint(1, 8)
    for _ in range(n_mut):
        op = rng.random()
        if op < 0.6 and buf:  # flip bytes
            i = rng.randrange(len(buf))
            buf[i] = rng.randrange(256)
        elif op < 0.8 and buf:  # truncate
            buf = buf[:rng.randrange(1, len(buf) + 1)]
        else:  # duplicate a slice
            if len(buf) > 4:
                a = rng.randrange(len(buf) - 2)
                b = min(len(buf), a + rng.randrange(1, 64))
                buf[a:a] = buf[a:b]
    return bytes(buf)


def first_sos_data(data: bytes) -> int:
    """Offset where the first scan's entropy data begins."""
    i = data.find(b"\xff\xda")
    if i < 0:
        return len(data)
    return i + 2 + int.from_bytes(data[i + 2:i + 4], "big")


def header_mutant(data: bytes, rng: random.Random) -> bytes:
    """1-4 byte writes before the first scan's data (tools/fuzz.py:222-229)."""
    buf = bytearray(data)
    sos = first_sos_data(data)
    for _ in range(rng.randint(1, 4)):
        buf[rng.randrange(2, max(3, sos))] = rng.randrange(256)
    return bytes(buf)


def entropy_mutant(data: bytes, rng: random.Random) -> bytes:
    """1-8 byte writes after the first SOS header (tools/fuzz.py:338-343)."""
    i = data.find(b"\xff\xda")
    lo = 2 if i < 0 else i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
    buf = bytearray(data)
    for _ in range(rng.randint(1, 8)):
        buf[rng.randrange(lo, len(buf))] = rng.randrange(256)
    return bytes(buf)


class _Hang(Exception):
    pass


@contextlib.contextmanager
def alarm(seconds: int):
    """SIGALRM raises _Hang in the body after `seconds` (main thread only;
    elsewhere the body runs unguarded)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def on_alarm(signum, frame):
        raise _Hang(f"exceeded {seconds}s")

    previous = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


class _Saver:
    def __init__(self, out: str):
        self.out = out

    def __call__(self, kind: str, i, data: bytes) -> str:
        os.makedirs(self.out, exist_ok=True)
        path = os.path.join(self.out, f"fuzz_{kind}_{i}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        return path


class _Chunks:
    """Non-seekable capped reader (socket stand-in) for the streaming leg."""

    def __init__(self, data: bytes):
        self._d, self._p = data, 0

    def read(self, n: int) -> bytes:
        n = min(n, 4096)
        c = self._d[self._p:self._p + n]
        self._p += len(c)
        return c


def _samples(info) -> int:
    ncomp = {"L8": 1, "L16": 1, "RGB24": 3, "CMYK32": 4}.get(
        info.pixel_format.name, 4)
    return info.width * info.height * ncomp


def host_outcome(data: bytes, streaming: bool = False,
                 max_samples: int = 16 << 20):
    """The port's `Decoder(backend="numpy")` on `data`, with the engine the
    environment selects: (decoded bytes or "ERR:<JpegError class>", the
    decoder). Frames above `max_samples` output samples stop after the
    header as "ERR:FormatError(oversize-precheck)" (tools/fuzz.py:166-177),
    or give None on the streaming leg."""
    from jpeg_decoder_tpu_torch import Decoder, JpegError

    d = Decoder(_Chunks(data) if streaming else data, backend="numpy",
                streaming=streaming)
    d.set_max_decoding_buffer_size(CAP)
    try:
        d.read_info()
        info = d.info()
        if info is not None and _samples(info) > max_samples:
            return (None if streaming
                    else "ERR:FormatError(oversize-precheck)"), d
        return d.decode(), d
    except JpegError as e:
        return f"ERR:{type(e).__name__}", d


def _set_engine(oracle: bool) -> None:
    """The host copy's entropy engine by the reference's switch: the
    environment variable, then a fresh engine lookup."""
    from jpeg_decoder_tpu_torch.host.entropy import native

    if oracle:
        os.environ["JPEG_TPU_DISABLE_NATIVE"] = "1"
    else:
        os.environ.pop("JPEG_TPU_DISABLE_NATIVE", None)
    native.reset_native_cache()


def pil_decode(data: bytes):
    """PIL's libjpeg decode: (mode, uint8 array), or None when PIL rejects
    the stream or its mode does not map cleanly."""
    import io

    from PIL import Image

    try:
        im = Image.open(io.BytesIO(data))
        im.load()
    except Exception:  # noqa: BLE001 — any PIL rejection skips the leg
        return None
    if im.mode not in ("L", "RGB"):
        return None
    return im.mode, np.asarray(im)


def compare_with_pil(ours: bytes, decoder, data: bytes):
    """None if incomparable, True if within 3, else a message (a shape
    disagreement starts with "shape")."""
    from jpeg_decoder_tpu_torch import CodingProcess, PixelFormat

    info = decoder.info()
    if info is None or info.coding_process == CodingProcess.LOSSLESS:
        return None
    pil = pil_decode(data)
    if pil is None:
        return None
    mode, theirs = pil
    if {PixelFormat.L8: "L", PixelFormat.RGB24: "RGB"}.get(
            info.pixel_format) != mode:
        return None
    mine = np.frombuffer(ours, np.uint8)
    if theirs.shape[:2] != (info.height, info.width) \
            or mine.size != theirs.size:
        return (f"shape mismatch: ours {info.width}x{info.height}, PIL "
                f"{theirs.shape}")
    diff = np.abs(mine.reshape(theirs.shape).astype(np.int16)
                  - theirs.astype(np.int16))
    if diff.max() <= PIXEL_TOL:
        return True
    return f"max diff {int(diff.max())}, {int((diff > 3).sum())} bad samples"


def run(iterations: int = 500, seed: int = 0, timeout_s: int = 60,
        seeds=None, out: str = None, log=print) -> int:
    """Host mode; returns the number of failures. Sets and clears
    JPEG_TPU_DISABLE_NATIVE: run it in a process of its own."""
    save = _Saver(out or default_out())
    corpus = list(seed_corpus(seeds).values())
    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    log("PIL leg: " + ("on (PIL imports)" if have_pil else
                       "skipped, PIL does not import here"))
    rng = random.Random(seed)
    failures = pil_compared = pil_diverged = 0
    for i in range(iterations):
        seed_bytes = rng.choice(corpus)
        if rng.random() < 0.3:
            data = header_mutant(seed_bytes, rng)
        else:
            data = mutate(seed_bytes, rng)
        try:
            with alarm(timeout_s):
                _set_engine(oracle=False)
                a, da = host_outcome(data)
                _set_engine(oracle=True)
                b, _ = host_outcome(data)
                c, _ = host_outcome(data, streaming=True,
                                    max_samples=4 << 20)
                verdict = (compare_with_pil(a, da, data)
                           if have_pil and isinstance(a, bytes) else None)
        except Exception as e:  # noqa: BLE001 — any non-JpegError is a bug
            failures += 1
            log(f"[{i}] CRASH {type(e).__name__}: {e} -> "
                f"{save('crash', i, data)}")
            continue
        finally:
            _set_engine(oracle=False)
        if a != b:
            failures += 1
            log(f"[{i}] NATIVE/ORACLE DIVERGENCE -> {save('diff', i, data)}")
        if c is not None and c != b:
            failures += 1
            log(f"[{i}] STREAMING/ORACLE DIVERGENCE -> "
                f"{save('stream', i, data)}")
        if verdict is not None:
            pil_compared += 1
            if verdict is not True:
                if verdict.startswith("shape"):
                    failures += 1
                    log(f"[{i}] PIL SHAPE DIVERGENCE ({verdict}) -> "
                        f"{save('pil', i, data)}")
                else:
                    pil_diverged += 1
                    save("pilnote", i, data)
        if (i + 1) % 100 == 0:
            log(f"{i + 1}/{iterations} done, {failures} failures, "
                f"{pil_compared} PIL-compared ({pil_diverged} invalid-stream "
                "diffs, expected)")
    log(f"fuzz complete: {iterations} mutants, {failures} failures, "
        f"{pil_compared} PIL-compared, {pil_diverged} invalid-stream diffs "
        "(informational)" + ("" if have_pil else "; PIL leg skipped (no PIL)"))
    return failures


# ---------------------------------------------------------------------------
# Device mode


@contextlib.contextmanager
def oracle_engine():
    """The host copy's Python entropy engine for the body, without touching
    the environment: the engine lookup answers None, as it does under
    JPEG_TPU_DISABLE_NATIVE. Nothing else may stage while it holds (the
    device mode runs the oracle between decode_stream calls)."""
    from jpeg_decoder_tpu_torch.host.entropy import native

    saved = native._native, native._attempted
    native._native, native._attempted = None, True
    try:
        yield
    finally:
        native._native, native._attempted = saved


@dataclasses.dataclass
class Oracle:
    """The host oracle's outcome for one source: `error` (a JpegError
    class name) or its stores by frame component, their tables, and the
    decoded bytes."""
    error: str = None
    stores: dict = None
    qts: dict = None
    pixels: bytes = None


def oracle_of(data: bytes) -> Oracle:
    """`Decoder(backend="numpy", precision="exact")` on the oracle engine:
    `_decode_entropy_only`, then the image from those stores."""
    from jpeg_decoder_tpu_torch.host.decoder import Decoder
    from jpeg_decoder_tpu_torch.host.errors import JpegError
    from jpeg_decoder_tpu_torch.host.parser import CodingProcess

    with oracle_engine():
        d = Decoder(data, backend="numpy", precision="exact")
        d.set_max_decoding_buffer_size(CAP)
        try:
            d._decode_entropy_only()
            lossless = d.frame.coding_process == CodingProcess.LOSSLESS
            stores = {i: s.reshape(-1).copy()
                      for i, (s, _q) in d._pending_render.items()}
            qts = {i: q.copy() for i, (_s, q) in d._pending_render.items()}
            pixels = (d._compute_image_lossless() if lossless
                      else d._compute_image())
        except JpegError as e:
            return Oracle(error=type(e).__name__)
    return Oracle(stores=stores, qts=qts, pixels=pixels)


def route_of(data: bytes) -> str:
    """Where the bits staging sends `data`: "accepted" (the prescan took
    every scan), "fallback" (PrescanFallback, a progressive frame or a scan
    the prescan declined: host decode, then transcode or the prefix
    interchange), "lossless", or "error" (a JpegError)."""
    from jpeg_decoder_tpu_torch.host.decoder import Decoder
    from jpeg_decoder_tpu_torch.host.entropy.prescan import PrescanFallback
    from jpeg_decoder_tpu_torch.host.errors import JpegError
    from jpeg_decoder_tpu_torch.host.staging import (BitstreamCapture,
                                                     _LosslessCapture)

    d = Decoder(data, backend="numpy")
    cap, ll = BitstreamCapture(), _LosslessCapture()
    d._prefix_capture, d._lossless_capture = cap, ll
    try:
        d._decode_entropy_only()
    except PrescanFallback:
        return "fallback"
    except JpegError:
        return "error"
    if ll.scans:
        return "lossless"
    return "accepted" if cap.used else "fallback"


class DeviceFuzz:
    """Device mode's checks on `device`, with its counts (`stats`) and
    failure log."""

    def __init__(self, device: str = "cuda", out: str = None, log=print):
        from jpeg_decoder_tpu_torch.params import DeviceParams
        from jpeg_decoder_tpu_torch.transfer import checked_device

        self.dev = checked_device(device)
        self.cuda = self.dev.type == "cuda"
        self.params = DeviceParams(self.dev)
        self.save = _Saver(out or default_out())
        self.log = log
        self.stats = {
            "sources": 0, "mutants": 0, "accepted": 0, "fallbacks": 0,
            "lossless": 0, "typed_errors": 0, "failures": 0,
            "fast_misses": 0, "fast_miss_max_dequantized": 0,
            "k1_scans_checked": 0, "k1_vs_plain_checked": 0,
            "k3_checked": 0, "k3_checked_on_mutants": 0,
            "l1_checked": 0, "l1_checked_on_mutants": 0,
            "decoder_checked": 0}

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def fail(self, i: int, kind: str, what: str, data: bytes) -> None:
        self.stats["failures"] += 1
        self.log(f"[{i}] {what} -> {self.save(kind, i, data)}")

    # -- per-source kernel checks -----------------------------------------

    def check_k1(self, staged, oracle: Oracle) -> tuple:
        """K1 on every scan of a staged bits image, against the oracle's
        stores (and on a card against the plain K1 on the card, K1 counted
        once per scan). Returns (a failure message or None, the stores by
        frame component as [n, 64] tensors on the device)."""
        import jpeg_decoder_tpu_torch as jt
        from jpeg_decoder_tpu_torch.entropy.assemble import (GeneralMaps,
                                                             assemble_nat)
        from jpeg_decoder_tpu_torch.entropy.chunk_decode import (
            decode_chunks, decode_chunks_plain, unpack_delta)

        stores = {}
        for st in staged.scans:
            wire = [torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)
                    for a in ((st.words, st.dm) if st.ab is None
                              else (st.words, st.dm, st.ab, st.base))]
            if st.ab is None:
                ab, base = unpack_delta(wire[1])
            else:
                ab, base = wire[2], wire[3]
            plan = st.scan.plan
            args = (wire[0], wire[1], ab, base, self.params.tables(st.scan),
                    st.s_max, plan.n_blocks)
            before = jt.LAUNCHES["huffman_decode"]
            nat = decode_chunks(*args)
            if self.cuda:
                if jt.LAUNCHES["huffman_decode"] != before + 1:
                    return "K1 NOT LAUNCHED ON THE CARD", stores
                plain = decode_chunks_plain(*args)
                self.sync()
                self.stats["k1_vs_plain_checked"] += 1
                if not torch.equal(nat, plain):
                    err = int((nat.to(torch.int32) - plain.to(torch.int32))
                              .abs().max())
                    return f"K1/PLAIN K1 DIVERGENCE (max |diff| {err})", \
                        stores
            maps = None if plan.structured is not None \
                else GeneralMaps(plan, self.dev)
            scan_stores = assemble_nat(nat, plan, maps)
            self.stats["k1_scans_checked"] += 1
            for pos, comp_i in st.kept:
                got = scan_stores[pos].reshape(-1).cpu().numpy()
                want = oracle.stores.get(comp_i)
                if want is None or not np.array_equal(got, want):
                    return (f"K1/ORACLE STORE DIVERGENCE (component "
                            f"{comp_i})"), stores
                stores[comp_i] = scan_stores[pos].reshape(-1, 64)
        return None, stores

    def check_k3(self, staged, stores: dict, mutated: bool):
        """K3 against its plain version on the planes of a fused-tail
        geometry (a card only); a failure message or None."""
        from jpeg_decoder_tpu_torch.host.ops.tail import (_TAIL_TRANSFORMS,
                                                          pallas_tail_mode)
        from jpeg_decoder_tpu_torch.ops.kernels import (fused_tail,
                                                        fused_tail_plain)
        from jpeg_decoder_tpu_torch.ops.pipeline import _planes

        geometry = staged.geometry
        if not self.cuda or pallas_tail_mode(geometry) != "fused" \
                or len(stores) != len(staged.qts):
            return None
        comps = geometry.components
        planes = [p[0] for p in _planes(
            geometry, [stores[i].reshape(1, -1, 64) for i in
                       range(len(comps))], [staged.qts], self.params,
            fp32=True)]
        chroma = next(((c.size_height, c.size_width) for c in comps
                       if c.upsampler_mode != "h1v1"), None)
        args = (planes, tuple(c.upsampler_mode for c in comps), chroma,
                _TAIL_TRANSFORMS[geometry.transform.value],
                geometry.out_height, geometry.out_width)
        a, b = fused_tail(*args), fused_tail_plain(*args)
        self.sync()
        self.stats["k3_checked"] += 1
        self.stats["k3_checked_on_mutants"] += mutated
        return None if torch.equal(a, b) else "K3/PLAIN K3 DIVERGENCE"

    def check_l1(self, staged, mutated: bool):
        """L1 against its plain version on a lossless source's differences,
        where `runs_l1` sends it to L1 (a card only)."""
        from jpeg_decoder_tpu_torch.host.ops.predictors import \
            _default_prediction
        from jpeg_decoder_tpu_torch.host.parser import Predictor
        from jpeg_decoder_tpu_torch.ops.predictors import (
            lossless_recur, lossless_recur_plain, runs_l1)

        if not self.cuda or not runs_l1(Predictor(staged.predictor),
                                        staged.point_transform,
                                        staged.restart_all):
            return None
        d = torch.from_numpy(
            staged.diffs.astype(np.int32)).to(self.dev)
        args = (d, staged.predictor, staged.point_transform,
                _default_prediction(staged.precision,
                                    staged.point_transform))
        a, b = lossless_recur(*args), lossless_recur_plain(*args)
        self.sync()
        self.stats["l1_checked"] += 1
        self.stats["l1_checked_on_mutants"] += mutated
        return None if torch.equal(a, b) else "L1/PLAIN L1 DIVERGENCE"

    # -- outcome checks ---------------------------------------------------

    def pixels_ok(self, img, oracle: Oracle, precision: str, lossless: bool
                  ) -> str:
        """"ok", "fast" (a fast-tier miss beyond 3) or a failure message,
        for one decoded image (a tensor or bytes) against the oracle."""
        got = img if isinstance(img, bytes) else img.cpu().numpy().tobytes()
        if precision == "exact" or lossless:
            if got == oracle.pixels:
                return "ok"
            return (f"{precision.upper()} PIXELS DIFFER FROM THE ORACLE "
                    f"({len(got)} vs {len(oracle.pixels)} bytes)")
        a = np.frombuffer(got, np.uint8)
        b = np.frombuffer(oracle.pixels, np.uint8)
        if a.shape != b.shape:
            return f"FAST SHAPE DIFFERS ({a.size} vs {b.size} bytes)"
        diff = int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()) \
            if a.size else 0
        return "ok" if diff <= PIXEL_TOL else "fast"

    def fast_miss(self, i: int, data: bytes, oracle: Oracle,
                  stores_agree: bool) -> None:
        """A fast pixel beyond 3: a miss of the fp32 product when the exact
        tier and the stores still agree with the oracle, else a failure."""
        import jpeg_decoder_tpu_torch as jt

        exact = jt.Decoder(data, backend="torch", precision="exact",
                           device=self.dev)
        exact.set_max_decoding_buffer_size(CAP)
        if not stores_agree or exact.decode() != oracle.pixels:
            self.fail(i, "dev_diff", "FAST MISS WITH THE EXACT TIER OR THE "
                      "STORES DIVERGING", data)
            return
        peak = max(int(np.abs(s.reshape(-1, 64).astype(np.int64)
                              * oracle.qts[c].astype(np.int64)).max())
                   for c, s in oracle.stores.items() if s.size)
        self.stats["fast_misses"] += 1
        self.stats["fast_miss_max_dequantized"] = max(
            self.stats["fast_miss_max_dequantized"], peak)
        self.log(f"[{i}] FAST MISS (fp32 product; exact and stores agree, "
                 f"largest dequantized coefficient {peak}) -> "
                 f"{self.save('dev_fast', i, data)}")

    def check_stream(self, base: int, sources: list, mutated: list,
                     interchange: str, precision: str) -> None:
        """Every check of one stream of sources (global indices from
        `base`) on one (interchange, precision) pair."""
        import jpeg_decoder_tpu_torch as jt
        from jpeg_decoder_tpu_torch.host.staging import stage_host
        from jpeg_decoder_tpu_torch.models.stream import (StagedBits,
                                                          StagedLossless,
                                                          stage_host_bits)
        from jpeg_decoder_tpu_torch.host.errors import JpegError

        n = len(sources)
        self.stats["sources"] += n
        self.stats["mutants"] += sum(mutated)
        oracles = [oracle_of(data) for data in sources]
        per = [{} for _ in range(n)]     # per-source notes
        for i, (data, oracle) in enumerate(zip(sources, oracles)):
            k = base + i
            route = route_of(data)
            self.stats[{"accepted": "accepted", "fallback": "fallbacks",
                        "lossless": "lossless",
                        "error": "typed_errors"}[route]] += 1
            if route == "accepted" and oracle.error:
                self.fail(k, "dev_accept", f"PRESCAN ACCEPTED, ORACLE RAISED "
                          f"{oracle.error}", data)
                per[i]["failed"] = True
                continue
            # The staging of this stream's interchange: its outcome must
            # be the oracle's.
            try:
                staged = (stage_host_bits(data, None, precision)
                          if interchange == "bits"
                          else stage_host(data, None, precision))
                staged_err = None
            except JpegError as e:
                staged, staged_err = None, type(e).__name__
            per[i]["staged_err"] = staged_err
            if staged_err != oracle.error:
                self.fail(k, "dev_diff", f"STAGING RAISED {staged_err}, "
                          f"ORACLE RAISED {oracle.error}", data)
                per[i]["failed"] = True
                continue
            if staged is None:
                continue
            bits = (staged if isinstance(staged, StagedBits)
                    else stage_host_bits(data, None, precision))
            if isinstance(bits, StagedBits):
                msg, stores = self.check_k1(bits, oracle)
                per[i]["stores_agree"] = msg is None
                if msg is None:
                    msg = self.check_k3(bits, stores, mutated[i])
                if msg:
                    self.fail(k, "dev_diff", msg, data)
                    per[i]["failed"] = True
            elif isinstance(bits, StagedLossless):
                per[i]["lossless"] = True
                msg = self.check_l1(bits, mutated[i])
                if msg:
                    self.fail(k, "dev_diff", msg, data)
                    per[i]["failed"] = True

        # The user entry points: decode_stream at batch 1 and BATCH, and
        # at bits/fast also the planar-pallas layout.
        runs = [("interleaved", 1), ("interleaved", BATCH)]
        if (interchange, precision) == ("bits", "fast"):
            runs.append(("planar-pallas", 1))
        outs = {}
        for layout, batch in runs:
            with jt.DeviceStreamDecoder(device=self.dev, host_threads=2,
                                        precision=precision, layout=layout,
                                        interchange=interchange) as dec:
                outs[layout, batch] = dec.decode_stream(
                    sources, batch_size=batch, on_error="none")
            self.sync()
        one = outs["interleaved", 1]
        for i, (data, oracle) in enumerate(zip(sources, oracles)):
            k = base + i
            if per[i].get("failed"):
                continue
            lossless = per[i].get("lossless", False)
            img = one[i]
            if (img is None) != (per[i]["staged_err"] is not None):
                self.fail(k, "dev_diff", f"decode_stream SLOT {type(img)} "
                          f"BUT STAGING RAISED {per[i]['staged_err']}", data)
                continue
            for (layout, batch), out in outs.items():
                other = out[i]
                if (layout, batch) == ("interleaved", 1):
                    continue
                if img is None or other is None:
                    same = img is None and other is None
                elif layout == "planar-pallas" and img.dim() == 3 \
                        and not lossless:
                    same = torch.equal(other, img.permute(2, 0, 1))
                else:
                    same = torch.equal(other, img)
                if not same:
                    self.fail(k, "dev_diff", f"{layout} AT BATCH {batch} "
                              "DIFFERS FROM THE BATCH-1 DECODE", data)
                    break
            else:
                if img is not None:
                    verdict = self.pixels_ok(img, oracle, precision,
                                             lossless)
                    if verdict == "fast":
                        self.fast_miss(k, data, oracle,
                                       per[i].get("stores_agree", True))
                    elif verdict != "ok":
                        self.fail(k, "dev_diff", f"decode_stream: {verdict}",
                                  data)
                self.check_decoder(k, data, oracle, precision, lossless)

    def check_decoder(self, k: int, data: bytes, oracle: Oracle,
                      precision: str, lossless: bool) -> None:
        """`Decoder(backend="torch")` on one source against the oracle."""
        import jpeg_decoder_tpu_torch as jt
        from jpeg_decoder_tpu_torch.host.errors import JpegError

        d = jt.Decoder(data, backend="torch", precision=precision,
                       device=self.dev)
        d.set_max_decoding_buffer_size(CAP)
        try:
            got, err = d.decode(), None
        except JpegError as e:
            got, err = None, type(e).__name__
        self.sync()
        self.stats["decoder_checked"] += 1
        if err != oracle.error:
            self.fail(k, "dev_diff", f"Decoder RAISED {err}, ORACLE RAISED "
                      f"{oracle.error}", data)
            return
        if got is None:
            return
        verdict = self.pixels_ok(got, oracle, precision, lossless)
        if verdict == "fast":
            self.fast_miss(k, data, oracle, True)
        elif verdict != "ok":
            self.fail(k, "dev_diff", f"Decoder: {verdict}", data)


def device_stream(seeds: list, rng: random.Random, n: int) -> tuple:
    """One stream of `n` sources: (sources, which are mutants)."""
    sources, mutated = [], []
    for _ in range(n):
        seed_bytes = rng.choice(seeds)
        m = rng.random() < MUTATED_SHARE
        sources.append(entropy_mutant(seed_bytes, rng) if m else seed_bytes)
        mutated.append(m)
    return sources, mutated


def run_device(iterations: int = 300, seed: int = 0, timeout_s: int = 60,
               seeds=None, out: str = None, device: str = "cuda",
               log=print) -> dict:
    """Device mode over `iterations` sources on `device`; returns the
    counts (`failures` among them) and the kernels' launches under the
    fuzz (`launches`, every wrapper call of the run, checks included)."""
    import jpeg_decoder_tpu_torch as jt

    fz = DeviceFuzz(device, out, log)
    corpus = list(seed_corpus(seeds).values())
    rng = random.Random(seed)
    fz.sync()
    jt.reset_launches()
    t0 = time.perf_counter()
    base, k = 0, 0
    while base < iterations:
        sources, mutated = device_stream(
            corpus, rng, min(STREAM_LEN, iterations - base))
        interchange, precision = PAIRS[k % len(PAIRS)]
        try:
            with alarm(timeout_s):
                fz.check_stream(base, sources, mutated, interchange,
                                precision)
        except Exception as e:  # noqa: BLE001 — any non-JpegError is a bug
            stamp = f"{base}-{base + len(sources) - 1}"
            fz.stats["failures"] += 1
            log(f"[{stamp}] CRASH {type(e).__name__}: {e} "
                f"({interchange}, {precision})")
            for j, data in enumerate(sources):
                fz.save("dev_crash", base + j, data)
        base += len(sources)
        k += 1
        if base % 96 < len(sources) or base >= iterations:
            s = fz.stats
            log(f"{base}/{iterations} sources: {s['accepted']} accepted, "
                f"{s['fallbacks']} fallbacks, {s['lossless']} lossless, "
                f"{s['typed_errors']} typed errors, {s['failures']} "
                f"failures")
    fz.sync()
    result = dict(fz.stats, launches=dict(jt.LAUNCHES),
                  seconds=time.perf_counter() - t0, device=str(fz.dev))
    if fz.cuda:
        result["device_name"] = torch.cuda.get_device_name(fz.dev)
    log("device fuzz complete: " + json.dumps(result))
    return result


# ---------------------------------------------------------------------------
# Coverage-guided mode


class _LineCoverage:
    """Line coverage over the port's host layers via sys.monitoring (PEP
    669), as tools/fuzz.py's: each (code, line) event is DISABLEd after its
    first firing, so "events fired this run" is the new-coverage count."""

    TOOL = 3  # sys.monitoring.OPTIMIZER_ID slot (unused in CPython today)

    def __init__(self, prefix: str):
        self.mon = sys.monitoring
        self.prefix = prefix
        self.total: set = set()
        self.run_new = 0
        self.mon.use_tool_id(self.TOOL, "jt-fuzz-torch-coverage")
        self.mon.register_callback(self.TOOL, self.mon.events.LINE,
                                   self._on_line)
        self.mon.set_events(self.TOOL, self.mon.events.LINE)

    def _on_line(self, code, line):
        if not code.co_filename.startswith(self.prefix):
            return self.mon.DISABLE
        key = (id(code), line)
        if key not in self.total:
            self.total.add(key)
            self.run_new += 1
        return self.mon.DISABLE

    def begin_run(self):
        self.run_new = 0

    def reset(self):
        """Re-arm every DISABLEd event and forget coverage."""
        self.total.clear()
        self.mon.restart_events()

    def close(self):
        self.mon.set_events(self.TOOL, 0)
        self.mon.register_callback(self.TOOL, self.mon.events.LINE, None)
        self.mon.free_tool_id(self.TOOL)


def run_guided(iterations: int = 2000, seed: int = 0, out_json: str = None,
               timeout_s: int = 20, lean_seeds: bool = False, seeds=None,
               out: str = None, log=print) -> int:
    """Coverage-feedback fuzzing of the port's host layers: inputs that
    light up new lines join the live corpus and are mutated more often.
    The flat random scheduler runs the same budget first; both curves go
    to `out_json`. Forces the oracle engine (JPEG_TPU_DISABLE_NATIVE): run
    it in a process of its own. Returns the number of crashes."""
    from jpeg_decoder_tpu_torch import Decoder, JpegError

    out = out or default_out()
    save = _Saver(out)
    if out_json is None:
        out_json = os.path.join(out, "fuzz_guided_curve_lean.json"
                                if lean_seeds else "fuzz_guided_curve.json")
    _set_engine(oracle=True)
    prefix = str(REPO / "jpeg_decoder_tpu_torch" / "host")
    corpus_seeds = list(seed_corpus([LEAN_SEED] if lean_seeds
                                    else seeds).values())
    crashes = []

    def decode_one(data: bytes) -> None:
        try:
            with alarm(timeout_s):
                d = Decoder(data, backend="numpy")
                d.set_max_decoding_buffer_size(1 << 24)
                d.decode()
        except (JpegError, _Hang):
            pass
        except Exception as e:  # noqa: BLE001 — a genuine fuzz find
            path = save("guided_crash", len(crashes), data)
            crashes.append((type(e).__name__, str(e)[:120], path))

    cov = _LineCoverage(prefix)

    def phase(guided: bool):
        rng = random.Random(seed)
        corpus = [bytes(s) for s in corpus_seeds]
        energy = [1.0] * len(corpus)
        curve = []
        for s in corpus:
            cov.begin_run()
            decode_one(s)
        for i in range(iterations):
            if guided:
                r = rng.random() * sum(energy)
                acc, pi = 0.0, 0
                for pi, e in enumerate(energy):
                    acc += e
                    if acc >= r:
                        break
            else:
                pi = rng.randrange(len(corpus_seeds))
            data = mutate(corpus[pi], rng)
            cov.begin_run()
            decode_one(data)
            if guided and cov.run_new > 0:
                corpus.append(data)
                energy.append(1.0 + cov.run_new)
                energy[pi] += 0.5
            if (i + 1) % 100 == 0:
                curve.append((i + 1, len(cov.total)))
        curve.append((iterations, len(cov.total)))
        return curve, len(corpus) - len(corpus_seeds)

    try:
        random_curve, _ = phase(guided=False)
        random_total = len(cov.total)
        cov.reset()
        guided_curve, grown = phase(guided=True)
        guided_total = len(cov.total)
    finally:
        cov.close()
        _set_engine(oracle=False)
    result = {
        "iterations": iterations, "seed": seed, "seeds": len(corpus_seeds),
        "random_final_lines": random_total,
        "guided_final_lines": guided_total, "guided_corpus_grown": grown,
        "random_curve": random_curve, "guided_curve": guided_curve,
        "crashes": crashes}
    os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(result, f)
    log(f"guided fuzz: {iterations} iters x2 phases, seeds "
        f"{len(corpus_seeds)}; lines random {random_total} -> guided "
        f"{guided_total} (+{guided_total - random_total}), corpus grew "
        f"{grown}; crashes {len(crashes)} -> {out_json}")
    for c in crashes:
        log(f"CRASH {c}")
    return len(crashes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("iterations", nargs="?", type=int, default=None,
                    help="mutants (device mode: sources); default 500, "
                         "300 in device mode, 2000 guided")
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("--device", action="store_true",
                    help="the device mode (decode_stream, Decoder and the "
                         "kernels against the host oracle)")
    ap.add_argument("--guided", action="store_true",
                    help="the coverage-guided mode (host only)")
    ap.add_argument("--lean-seeds", action="store_true",
                    help="guided mode from one small fixture")
    ap.add_argument("--torch-device", default="cuda",
                    choices=("cuda", "cpu"),
                    help="where the port runs in device mode")
    ap.add_argument("--seeds", default=None,
                    help="comma-separated seed names (fixture file names, "
                         f"{', '.join(SOF3_SEEDS)}, quirk.jpg)")
    ap.add_argument("--out", default=None,
                    help="directory for failing mutants and the guided "
                         "curves (default: fuzz_torch/ in the temporary "
                         "directory)")
    args = ap.parse_args(argv)
    seeds = args.seeds.split(",") if args.seeds else None
    if args.guided:
        return 1 if run_guided(args.iterations or 2000, args.seed,
                               lean_seeds=args.lean_seeds, seeds=seeds,
                               out=args.out) else 0
    if args.device:
        res = run_device(args.iterations or 300, args.seed, seeds=seeds,
                         out=args.out, device=args.torch_device)
        return 1 if res["failures"] else 0
    return 1 if run(args.iterations or 500, args.seed, seeds=seeds,
                    out=args.out) else 0


if __name__ == "__main__":
    sys.exit(main())

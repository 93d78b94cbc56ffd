"""Kernel L1's schedule and launch rule, on the CPU.

The schedule model: a replay in numpy of `csrc/lossless_recur.cu`'s warp
schedule, built from the kernel's own constants (read from the source): a
warp per band of kBand rows, lane l at column 16 s - l + i in step i of
phase s (lane 31 finishing strip q in phase q + kLag), band b on warp b
mod nwarps (the warps of all CTAs of the
cluster), the band's last row handed down through an inbox of kHandoff
strips (the producer waiting until the consumer took what a slot held)
inside a round, and as one whole row across rounds (the consumer waiting
for all of it), the waits on the barriers as the kernel makes them. Warps
move in a seeded random order, some skipping turns, as warps on the card
drift apart. For every sample (y, x) the model asserts that r[y][x-1],
r[y-1][x] and r[y-1][x-1] were produced at an earlier step, that lane 0
reads the row above from a ring or row slot that holds exactly that row's
column (never a stale or overwritten one), and that the warps never all
wait at once (no deadlock).

The launch rule: `lossless_image` for 3-component SOF3 streams that go to
L1 (predictor 3 at pt 0 through the Rc chain, predictor 6) calls
`lossless_recur` once for the image, bit-equal to the JAX package's
`_compiled_lossless_pipeline` through its `DeviceStreamDecoder`; the closed
forms never call it.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from jpeg_decoder_tpu.models.stream import \
    DeviceStreamDecoder as JaxStreamDecoder
from jpeg_decoder_tpu_torch import DeviceStreamDecoder
from jpeg_decoder_tpu_torch.host.parser import Predictor
from jpeg_decoder_tpu_torch.ops import predictors as port
from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

SOURCE = (Path(__file__).resolve().parents[1] / "jpeg_decoder_tpu_torch"
          / "csrc" / "lossless_recur.cu").read_text()
K = {}
for _name, _expr in re.findall(r"constexpr int (k\w+) = ([\w\s+\-*/()]+);",
                               SOURCE):
    if "sizeof" not in _expr:       # C integer arithmetic on the constants
        K[_name] = eval(_expr.replace("/", "//"), {}, dict(K))
BAND, STRIP, HANDOFF, LAG = K["kBand"], K["kStrip"], K["kHandoff"], K["kLag"]
SIDES = (1, 31, 32, 33, 100, 1100)


def kernel_plan(h: int, w: int) -> tuple:
    """`plan()` in the kernel: (CTAs of the cluster, warps of a CTA), about
    kWarpsPerSm bands to a CTA, up to kMaxCtas CTAs and kMaxWarps warps,
    fewer warps where the row handed across rounds needs the shared
    memory. A warp's shared memory: its staging tile, its inbox and two
    barriers per inbox slot."""
    nb = -(-h // BAND)
    ctas = min(K["kMaxCtas"], -(-nb // K["kWarpsPerSm"]))
    warp_bytes = BAND * K["kPitch"] * 4 + HANDOFF * K["kStripBytes"] \
        + HANDOFF * 16
    for n in range(min(K["kMaxWarps"], -(-nb // ctas)), 0, -1):
        if n * warp_bytes + 16 + -(-w // STRIP) * K["kStripBytes"] \
                <= K["kMaxSmem"]:
            return ctas, n
    raise AssertionError("no plan fits")


class Deadlock(AssertionError):
    pass


def replay(h: int, w: int, nwarps: int, seed: int) -> np.ndarray:
    """Run the schedule; return the step at which each sample was made."""
    nb, nst = -(-h // BAND), -(-w // STRIP)
    nw = min(nwarps, nb)
    made = np.full((h, w), -1, np.int64)
    pub, cons, bpub = [0] * nw, [0] * nw, [0]
    ring = np.full((nw, HANDOFF * STRIP), -1, np.int64)   # tags y * w + x
    cross = np.full(w, -1, np.int64)
    # Per warp: [band, phase s, "pre" (before the phase) or "post"].
    state = [[wp, 0, "pre"] for wp in range(nw)]
    rng = np.random.default_rng(seed)
    lanes = np.arange(BAND)
    clock = 0

    def try_act(wp: int) -> bool:
        nonlocal clock
        band, s, stage = state[wp]
        y0 = band * BAND
        rnd = band // nw
        up = (wp - 1) % nw
        above_crosses, below_crosses = wp == 0, wp == nw - 1
        has_above, has_below = band > 0, band + 1 < nb
        k_in = (rnd - 1 if above_crosses else rnd) * nst
        k_out = rnd * nst
        if stage == "pre":
            reads = has_above and s < nst
            if reads:       # across rounds the whole row, before strip 0
                have, need = (bpub[0], rnd * nst) if above_crosses \
                    else (pub[up], k_in + s + 1)
                if have < need:
                    return False
            if reads and not above_crosses:
                cons[up] = k_in + s + 1     # lane 0 holds the strip now
            for i in range(STRIP):
                x = STRIP * s - lanes + i
                y = y0 + lanes
                ok = (x >= 0) & (x < w) & (y < h)
                made[y[ok], x[ok]] = clock
                if reads and x[0] < w:
                    slot = cross[x[0]] if above_crosses else ring[
                        up, ((k_in + s) % HANDOFF) * STRIP + i]
                    assert slot == (y0 - 1) * w + x[0], \
                        f"band {band} read {slot} for column {x[0]}"
                clock += 1
            state[wp][2] = "post"
            return True
        if s >= LAG and has_below:
            q = s - LAG
            k = k_out + q
            if not below_crosses and cons[wp] < k - HANDOFF + 1:
                return False
            cols = np.arange(q * STRIP, min(w, q * STRIP + STRIP))
            assert (made[y0 + BAND - 1, cols] >= 0).all()
            tags = (y0 + BAND - 1) * w + cols
            if below_crosses:
                cross[cols] = tags
                bpub[0] = k + 1
            else:
                ring[wp, (k % HANDOFF) * STRIP + cols - q * STRIP] = tags
                pub[wp] = k + 1
        state[wp][1:] = [s + 1, "pre"]
        if s + 1 == nst + LAG:
            state[wp][:2] = [band + nw, 0]
        return True

    while any(st[0] < nb for st in state):
        live = [wp for wp in range(nw) if state[wp][0] < nb]
        moved = False
        for wp in rng.permutation(live):
            if rng.random() < 0.3:      # this warp is slow this turn
                continue
            moved |= try_act(int(wp))
        if not moved and not any(try_act(wp) for wp in live):
            raise Deadlock(f"every warp waits: {state}")
    return made


@pytest.mark.parametrize("nwarps", [1, 4, 32])
@pytest.mark.parametrize("w", SIDES)
@pytest.mark.parametrize("h", SIDES)
def test_schedule_produces_every_neighbour_first(h, w, nwarps):
    made = replay(h, w, nwarps, seed=h * 7919 + w * 31 + nwarps)
    assert (made >= 0).all()
    assert (made[:, 1:] > made[:, :-1]).all()           # Ra
    assert (made[1:, :] > made[:-1, :]).all()           # Rb
    assert (made[1:, 1:] > made[:-1, :-1]).all()        # Rc


@pytest.mark.parametrize("h,w", [(2048, 2048), (70000, 30), (40, 65535),
                                 (2 ** 31 // 65535 - 1, 65535), (1, 5),
                                 (300, 7)])
def test_kernel_plan_fits_shared_memory(h, w):
    """The kernel's cluster for these planes: a warp for every band up to
    kMaxCtas x kMaxWarps, and 8 CTAs of kWarpsPerSm warps at 2048 x 2048."""
    ctas, n = kernel_plan(h, w)
    nb = -(-h // BAND)
    assert 1 <= ctas <= K["kMaxCtas"] and 1 <= n <= K["kMaxWarps"]
    assert ctas * n >= min(nb, 2)
    if (h, w) == (2048, 2048):
        assert (ctas, n) == (8, K["kWarpsPerSm"])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("h,w", [(40 * BAND + 5, 300), (300 * BAND, 40)])
def test_schedule_at_the_kernels_cluster(h, w, seed):
    """Bands of one or several rounds over the warps of the cluster the
    kernel picks."""
    ctas, n = kernel_plan(h, w)
    made = replay(h, w, ctas * n, seed)
    assert (made[:, 1:] > made[:, :-1]).all()
    assert (made[1:, 1:] > made[:-1, :-1]).all()
    assert (made[1:, :] > made[:-1, :]).all()


@pytest.mark.parametrize("predictor,pt,want", [
    (0, 0, False), (1, 0, False), (2, 0, False), (3, 0, True),
    (4, 0, False), (5, 0, True), (6, 0, True), (7, 0, True),
    (0, 2, True), (2, 1, True), (3, 3, True), (4, 2, True), (6, 2, True)])
def test_runs_l1_follows_the_reference_rule(predictor, pt, want):
    assert port.runs_l1(Predictor(predictor), pt, False) is want
    assert port.runs_l1(Predictor(predictor), pt, True) is False


@pytest.mark.parametrize("predictor,pt,calls", [(3, 0, 1), (6, 0, 1),
                                                (6, 2, 1), (2, 0, 0)])
def test_lossless_image_calls_l1_once_for_all_components(
        monkeypatch, predictor, pt, calls):
    samples = sof3_samples(21, 18, 3, 12, pt, seed=predictor * 10 + pt)
    data = sof3_jpeg(samples, predictor, pt, 12)
    seen = []
    real = port.lossless_recur

    def counted(diffs, *args):
        seen.append(tuple(diffs.shape))
        return real(diffs, *args)

    monkeypatch.setattr(port, "lossless_recur", counted)
    with DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
        got = dec.decode_stream([data])[0]
    assert seen == [(3, 21, 18)] * calls
    want = np.asarray(JaxStreamDecoder(host_threads=1, interchange="bits")
                      .decode_stream([data])[0])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  samples.astype(np.int64) << pt)

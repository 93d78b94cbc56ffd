"""Copy of `jpeg_decoder_tpu/utils/link.py` at commit 0c2d0ea: the observed
host-to-card link state, shared by throughput policies, with a
host-to-card copy through PyTorch in place of `jax.device_put`.

The stream decoder keys its heterogeneous-merge policy on it
(`JPEG_TPU_HETERO_BITS=auto`, `models/stream.py`): merging mixed sizes
into one Huffman sweep trades more dispatches (one sweep plus one
reconstruction per plan) for fewer sweeps, which inverts when a slow link
makes each dispatch's transfer dominate.

State is fed two ways: opportunistic EMA updates from real transfers
(`record_transfer`, from the stream's H2D submissions) and an explicit
probe (`probe`, TTL-cached) when nothing has been observed recently.
`JPEG_TPU_LINK_MB_S` overrides both (A/B harnesses pin the policy
regardless of the live link).

The constants are the reference's policy, not measurements of a card: a
pinned copy to a card runs faster than the 5000 MB/s cap, so on a card
every sample is dropped and `degraded()` answers False, the reference's
healthy default.
"""

from __future__ import annotations

import os
import time

# EMA of observed H2D rate and the wall-clock of the last update.
_state = {"mb_s": None, "t": 0.0}

DEGRADED_MB_S = 120.0     # below: per-dispatch RTT dominates small batches
_TTL_S = 60.0
_EMA = 0.3


def record_transfer(nbytes: int, seconds: float) -> None:
    """Fold a real observed H2D transfer into the EMA (cheap; called from
    the stream's h2d_submit paths for multi-MB puts only — small puts time
    dispatch overhead, not bandwidth)."""
    if seconds <= 0 or nbytes < (1 << 20):
        return
    rate = nbytes / 1e6 / seconds
    if rate > 5000.0:
        # Faster than the link can physically move bytes: the put returned
        # asynchronously and we timed enqueue, not transfer — no signal.
        return
    cur = _state["mb_s"]
    _state["mb_s"] = rate if cur is None else (1 - _EMA) * cur + _EMA * rate
    _state["t"] = time.monotonic()


def probe(n_mb: int = 2) -> float:
    """Measure the link directly with one host-to-card copy of `n_mb` MB
    (synchronised) and fold it into the EMA; returns MB/s. Needs a CUDA
    device: without one it raises."""
    import numpy as np
    import torch

    buf = torch.from_numpy(np.empty(n_mb << 20, np.uint8))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf.to("cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    record_transfer(n_mb << 20, dt)
    return (n_mb << 20) / 1e6 / max(dt, 1e-9)


def link_mb_s(allow_probe: bool = True) -> float:
    """Current belief about the H2D link rate in MB/s. Env override first;
    then the EMA if fresh; else one probe (TTL-cached). Returns +inf when
    probing is disallowed and nothing has been observed (policies then
    behave as on a healthy link)."""
    v = os.environ.get("JPEG_TPU_LINK_MB_S")
    if v:
        try:
            return float(v)
        except ValueError:
            pass
    fresh = time.monotonic() - _state["t"] < _TTL_S
    if _state["mb_s"] is not None and fresh:
        return _state["mb_s"]
    if allow_probe:
        try:
            return probe()
        except Exception:
            pass
    return _state["mb_s"] if _state["mb_s"] is not None else float("inf")


def degraded(allow_probe: bool = False) -> bool:
    """True when the observed link is in a degraded phase. Defaults to NOT
    probing (policy checks must not add synchronous RTTs to the hot path);
    with no observations yet this answers False (healthy-link behavior)."""
    return link_mb_s(allow_probe=allow_probe) < DEGRADED_MB_S

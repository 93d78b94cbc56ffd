"""Seeded photo-like pixels: the recipe of `tools/make_torch_fixtures.py::
textured` (low-frequency gradients, six plane waves a channel, Gaussian
grain), copied and rearranged so that a 3.4 Mpix image takes well under a
second: every term of a channel is separable in rows and columns, so the
channel is one [H, r] x [r, W] product plus the grain.

Pure noise would compress ~10x worse than a photograph; this lands near
real-photo bits per pixel at the qualities photographs are stored at.
"""

from __future__ import annotations

import os

import numpy as np

# Threads that make a pool's images (NumPy drops the interpreter lock in
# its array operations).
THREADS = min(8, os.cpu_count() or 1)


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    """A generator from the run's `--seed` (any whole number, negative or
    past 64 bits included) and a salt per image and purpose."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), *salt]))


def textured_parts(h: int, w: int, channels: int,
                   rng: np.random.Generator) -> tuple:
    """(float32 [H, W, C] waves, float32 [H, W, C] standard normal grain):
    `textured` before its grain is scaled, added and clipped. Per channel:
    128 + 60 * sin(x / w * pi * (1 + c)) * cos(y / h * pi * (2 - c / 2)),
    six waves a * sin(fx x + fy y + phase) (fx, fy in [-0.08, 0.08], a in
    [5, 20])."""
    y = np.arange(h, dtype=np.float64)
    x = np.arange(w, dtype=np.float64)
    out = np.empty((h, w, channels), np.float32)
    for c in range(channels):
        rows = [np.cos(y / h * np.pi * (2 - c * 0.5))]
        cols = [60 * np.sin(x / w * np.pi * (1 + c))]
        for _ in range(6):
            fx, fy = rng.uniform(-0.08, 0.08, 2)
            phase = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(5, 20)
            # sin(a + b) = sin(a) cos(b) + cos(a) sin(b)
            rows += [np.cos(fy * y), np.sin(fy * y)]
            cols += [amp * np.sin(fx * x + phase), amp * np.cos(fx * x + phase)]
        out[..., c] = 128 + np.stack(rows, 1) @ np.stack(cols, 0)
    return out, rng.standard_normal(out.shape, dtype=np.float32)


def grained(waves: np.ndarray, grain: np.ndarray, noise: float) -> np.ndarray:
    """uint8 pixels: `waves` plus `grain` of standard deviation `noise`,
    clipped; one channel as [H, W]."""
    px = np.clip(waves + grain * np.float32(noise), 0, 255).astype(np.uint8)
    return px[..., 0] if px.shape[-1] == 1 else px

"""The comparison that decides `correct`.

The window's sampled calls were copied to the host as they completed: for
each distinct call input, one call among its first cycles and one issued
late in the window, both drawn from the seed (`sample`), so that a call
that returns an earlier call's outputs, or outputs that go wrong as the
window goes on, are seen. Once the window has closed and the program's
state is freed, the configuration's plain reference works each of their
images out again from what the generator made, and every output is
compared with it, element by element. Each number has its limit; every
limit is 0 (the exact tier is bit-exact by the configuration's
guarantee).
"""

from __future__ import annotations

import torch

# name -> limit. max_abs_diff: the largest |output - reference| over every
# compared element; wrong_images: compared images that differ from the
# reference anywhere, or in shape or dtype; missing_images: images a
# sampled call did not return; uncompared_calls: sampled calls (two per
# distinct call input) that never completed or were never issued.
LIMITS = {"max_abs_diff": 0, "wrong_images": 0, "missing_images": 0,
          "uncompared_calls": 0}
# Where in the window a late call is drawn: from this share of its length
# to the next.
LATE = (0.5, 0.9)


def sample(rng, inputs: int, cycles: int) -> tuple:
    """({call index: input index}, {input index: seconds share}): for each
    of the `inputs` distinct call inputs (call k takes input k % inputs),
    one call among its first `cycles`, and a share of the window in
    `LATE` from which its next call is kept."""
    early = {int(rng.integers(cycles)) * inputs + g: g for g in range(inputs)}
    late = {g: float(rng.uniform(*LATE)) for g in range(inputs)}
    return early, late


def compare(kept: dict, sampled: list, calls: list, pool: list, expected,
            device) -> dict:
    """{name: value} of `LIMITS`' numbers. `kept`: {call: host outputs};
    `sampled`: (call index or None where it was never issued, input
    index) for each sampled call; `calls[g]`: the pool indices of input
    g's images; `expected(item, device)`: the reference's output for one
    pool item."""
    vals = dict.fromkeys(LIMITS, 0)
    refs: dict = {}
    for k, g in sampled:
        outs = kept.get(k)
        if outs is None:
            vals["uncompared_calls"] += 1
            continue
        items = calls[g]
        vals["missing_images"] += max(0, len(items) - len(outs))
        for out, i in zip(outs, items):
            if i not in refs:
                refs[i] = expected(pool[i], device)
            ref = refs[i]
            if out.shape != ref.shape or out.dtype != ref.dtype:
                vals["wrong_images"] += 1
                continue
            diff = int((out.to(device, torch.int32) - ref.to(torch.int32))
                       .abs().max())
            vals["max_abs_diff"] = max(vals["max_abs_diff"], diff)
            vals["wrong_images"] += diff > 0
    return vals


def passed(vals: dict) -> bool:
    return all(vals[name] <= limit for name, limit in LIMITS.items())

"""The prefix rebuild (`entropy/prefix.py`, kernel P1's plain version)
against the JAX package's prefix pipeline, on the CPU.

The same staged wires (the JAX package's `stage_host` and the port's give
equal arrays, the residuals in one order or another) go through `jpeg_decoder_tpu.models.stream.
_compiled_prefix_pipeline` (one image) and `_compiled_prefix_pipeline_
batched` (a group of 4) at precision "exact" under `jax.jit`, and through
the port's `DeviceStreamDecoder(device="cpu", interchange="prefix")`
(`decode_one`, and `_group_wires` + `_run_group` for the group): pixels
bit-equal (tolerance 0: integer arithmetic throughout). Besides the real
residuals, hand-made ones: negative indices (JAX's `.at[i].add(mode=
"drop")` reads i in [-total, 0) as i + total and drops anything below),
duplicates whose sum wraps in int16, and indices at and past the end. The
inputs: the small fixtures, tower_420 and `q100/q100_420.jpg`, whose
residuals fill zigzag slots 16-63. Also the wrapper's dispatch (CPU
tensors take the plain version, a device without P1 raises) and the
cached permutation.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu.models.stream import (_compiled_prefix_pipeline,
                                            _compiled_prefix_pipeline_batched)
from jpeg_decoder_tpu.models.stream import stage_host as jax_stage_host
from jpeg_decoder_tpu_torch.entropy import prefix
from jpeg_decoder_tpu_torch.entropy.prefix import (prefix_stores,
                                                   prefix_stores_plain)
from jpeg_decoder_tpu_torch.host.staging import stage_host
from jpeg_decoder_tpu_torch.models.stream import DeviceStreamDecoder

from torch_inputs import SMALL_FIXTURES, fixture, synth_jpeg

INPUTS = SMALL_FIXTURES + ("tower_420.jpg", "q100/q100_420.jpg")


def hand_made_residuals(staged, seed: int) -> tuple:
    """The image's real residuals, then negative indices in range (the last
    coefficient, the first, some of the real ones read from the end), one
    below the range, duplicates of a real index whose values wrap, the sink
    and indices past it; padded with the sink to a multiple of 256."""
    rng = np.random.default_rng(seed)
    total = staged.total_coeffs
    real = staged.resid_idx < total
    idx, vals = staged.resid_idx[real], staged.resid_vals[real]
    pick = rng.integers(0, total, 6)
    extra_idx = np.concatenate([
        [-1, -total, -total - 1, -(2 ** 31)], pick - total,
        [pick[0]] * 5, [total, total + 1, 2 ** 31 - 1]]).astype(np.int32)
    extra_vals = np.concatenate([
        rng.integers(-32768, 32768, 10), [32767] * 5,
        rng.integers(-32768, 32768, 3)]).astype(np.int16)
    idx = np.concatenate([idx, extra_idx])
    vals = np.concatenate([vals, extra_vals])
    width = -(-len(idx) // 256) * 256
    ri = np.full(width, total, np.int32)
    rv = np.zeros(width, np.int16)
    ri[:len(idx)], rv[:len(idx)] = idx, vals
    return ri, rv


def _both(data: bytes, seed: int) -> tuple:
    """(the JAX package's staging, the port's), with the same hand-made
    residuals."""
    jst = jax_stage_host(data, precision="exact")
    pst = stage_host(data, precision="exact")
    for key in ("dc", "ac"):
        np.testing.assert_array_equal(getattr(jst, key), getattr(pst, key))
    # The same residuals; a restart-segmented scan may list them in another
    # order (its segments decode on a thread pool).
    jo, po = (np.lexsort((st.resid_vals, st.resid_idx)) for st in (jst, pst))
    for key in ("resid_idx", "resid_vals"):
        np.testing.assert_array_equal(getattr(jst, key)[jo],
                                      getattr(pst, key)[po])
    ri, rv = hand_made_residuals(pst, seed)
    return (dataclasses.replace(jst, resid_idx=ri, resid_vals=rv),
            dataclasses.replace(pst, resid_idx=ri, resid_vals=rv))


@pytest.mark.parametrize("name", INPUTS)
def test_prefix_rebuild_matches_the_jax_pipeline(name):
    data = fixture(name)
    jst, pst = _both(data, seed=len(name))
    fn = _compiled_prefix_pipeline(jst.geometry, len(jst.resid_idx))
    want = np.asarray(fn(jst.dc, jst.ac, jst.resid_idx, jst.resid_vals,
                         jst.qts))
    with DeviceStreamDecoder(device="cpu", host_threads=1, precision="exact",
                             interchange="prefix") as dec:
        got = dec.decode_one(pst).numpy()
        unedited = dec.decode_one(stage_host(data, precision="exact"))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, unedited.numpy()), \
        "the hand-made residuals must change the image"


def test_prefix_group_rebuild_matches_the_batched_jax_pipeline():
    """A group of 4 of one geometry (tower_420's array re-encoded at other
    seeds is another image of the same geometry), each with hand-made
    residuals, negative ones included: the port's merge reads them per
    image before the offsets, as the batched pipeline's vmap does."""
    blobs = [synth_jpeg(128, 96, seed=s) for s in range(4)]
    pairs = [_both(b, seed=10 + i) for i, b in enumerate(blobs)]
    jax_group = [j for j, _ in pairs]
    width = max(len(j.resid_idx) for j in jax_group)

    def padded(a, fill):
        return np.concatenate([a, np.full(width - len(a), fill, a.dtype)])

    fn = _compiled_prefix_pipeline_batched(jax_group[0].geometry, width, 4)
    want = np.asarray(fn(
        np.stack([j.dc for j in jax_group]),
        np.stack([j.ac for j in jax_group]),
        np.stack([padded(j.resid_idx, j.total_coeffs) for j in jax_group]),
        np.stack([padded(j.resid_vals, 0) for j in jax_group]),
        tuple(np.stack([j.qts[c] for j in jax_group])
              for c in range(len(jax_group[0].qts)))))
    group = [p for _, p in pairs]
    with DeviceStreamDecoder(device="cpu", host_threads=1, precision="exact",
                             interchange="prefix") as dec:
        got = dec._run_group("prefix", group,
                             dec._group_wires("prefix", group))
        single = [dec.decode_one(p) for p in group]
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy(), want[i])
        assert torch.equal(got[i], single[i])


def test_prefix_stores_dispatch():
    """CPU tensors take the plain version; a device without P1 raises."""
    pst = stage_host(fixture("small_444.jpg"))
    wire = [torch.from_numpy(a) for a in (pst.dc, pst.ac, pst.resid_idx,
                                          pst.resid_vals)]
    got = prefix_stores(pst.geometry, *wire)
    want = prefix_stores_plain(pst.geometry, *wire)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="no P1 implementation"):
        prefix_stores(pst.geometry, *(t.to("meta") for t in wire))


def test_the_permutation_is_made_once_per_device():
    assert prefix._natural_perm(torch.device("cpu")) \
        is prefix._natural_perm(torch.device("cpu"))

"""K3 module of the PyTorch port (jpeg_decoder_tpu_torch/ops/kernels.py
fused_tail, ops/pipeline.py reconstruct_planar_pallas) against the JAX
package's `fused_tail_pallas` and `reconstruct_planar_pallas`, both in
Pallas interpret mode on the CPU.

On the CPU `fused_tail` runs its plain PyTorch version. Tolerances:
- the tail: bit-equal, both sides are the same integer arithmetic;
- the planar reconstruction: bit-equal on these inputs. Its IDCT is fp32
  on both sides (torch's matmul here, the Pallas kernel's dot there) and
  may differ by 1 in general (tests/test_torch_idct_kernel.py); on the
  fixtures and scaled decodes below it does not, so any difference is a
  fault of the tail or of its plumbing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_decoder_tpu import Decoder
from jpeg_decoder_tpu.ops.pipeline import geometry_from_frame
from jpeg_decoder_tpu.ops.pallas_kernels import fused_tail_pallas
from jpeg_decoder_tpu.ops.pallas_kernels import \
    reconstruct_planar_pallas as jax_reconstruct_planar_pallas
from jpeg_decoder_tpu_torch import stage_host_bits
from jpeg_decoder_tpu_torch.ops.kernels import fused_tail, fused_tail_plain
from jpeg_decoder_tpu_torch.ops.pipeline import reconstruct_planar_pallas
from jpeg_decoder_tpu_torch.params import DeviceParams

from torch_inputs import (SMALL_FIXTURES, TAIL_CASES, fixture, synth_jpeg,
                          tail_planes)


@pytest.mark.parametrize("name", TAIL_CASES)
def test_fused_tail_plain_bit_equal_to_jax(name):
    modes, transform, out_h, out_w, chroma = TAIL_CASES[name]
    planes = tail_planes(name, seed=len(name))
    ref = np.asarray(fused_tail_pallas(
        [jnp.asarray(p) for p in planes], modes, chroma, transform, out_h,
        out_w, row_tile=32, interpret=True))
    tensors = [torch.from_numpy(p) for p in planes]
    got = fused_tail(tensors, modes, chroma, transform, out_h, out_w)
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == ref.shape == (len(planes), out_h, out_w)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        fused_tail_plain(tensors, modes, chroma, transform, out_h,
                         out_w).numpy(), ref)


def _stores(data: bytes, scale_to=None):
    d = Decoder(data, backend="numpy")
    if scale_to is not None:
        d.scale(*scale_to)
    d._decode_entropy_only()
    n = len(d.frame.components)
    transform = None if n == 1 else d._determine_color_transform()
    return ([d._pending_render[i][0].reshape(-1, 64) for i in range(n)],
            [d._pending_render[i][1] for i in range(n)],
            geometry_from_frame(d.frame, transform, precision="fast"))


def _planar_vs_jax(data: bytes, scale_to=None):
    """The port's geometry (its own staging) and the reference's (the JAX
    package's host decode), each to its own planar reconstruction."""
    geometry = stage_host_bits(data, scale_to).geometry
    stores, qts, ref_geometry = _stores(data, scale_to)
    ref = np.asarray(jax_reconstruct_planar_pallas(
        ref_geometry, [jnp.asarray(s) for s in stores],
        [jnp.asarray(q) for q in qts], interpret=True))
    got = reconstruct_planar_pallas(
        geometry, [torch.from_numpy(s)[None] for s in stores], [qts],
        DeviceParams("cpu"))[0]
    assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    return geometry


@pytest.mark.parametrize("name", SMALL_FIXTURES)
def test_reconstruct_planar_pallas_bit_equal_to_jax(name):
    _planar_vs_jax(fixture(name))


@pytest.mark.parametrize("scale_to", [(320, 240), (160, 120), (80, 60),
                                      (51, 36)])
def test_reconstruct_planar_pallas_scaled_bit_equal_to_jax(scale_to):
    data = synth_jpeg(640, 480, seed=24) if scale_to[0] % 5 == 0 \
        else synth_jpeg(203, 141, seed=25)
    geometry = _planar_vs_jax(data, scale_to)
    assert (geometry.out_width, geometry.out_height) == scale_to
    assert geometry.components[0].dct_scale < 8


@pytest.mark.parametrize("change,match", [
    ({"transform": "rgb"}, "transform"),
    ({"comp_modes": ("h1v1", "h2v2", "h1v2")}, "h1v2 mixed"),
    ({"comp_modes": ("h1v1", "h2v2")}, "takes 3"),
    ({"comp_modes": ("h1v1", "generic", "generic")}, "modes"),
    ({"chroma_dims": None}, "chroma_dims"),
    ({"chroma_dims": (40, 83)}, "does not cover"),
    ({"out_w": 1000}, "does not cover"),
])
def test_fused_tail_rejects_what_it_is_not_defined_on(change, match):
    modes, transform, out_h, out_w, chroma = TAIL_CASES["420_odd"]
    args = {"planes": [torch.from_numpy(p)
                       for p in tail_planes("420_odd")],
            "comp_modes": modes, "chroma_dims": chroma,
            "transform": transform, "out_h": out_h, "out_w": out_w}
    args.update(change)
    if len(args["comp_modes"]) == 2:
        args["planes"] = args["planes"][:2]
    with pytest.raises(ValueError, match=match):
        fused_tail(**args)


def test_fused_tail_raises_off_cpu_and_cuda():
    modes, transform, out_h, out_w, chroma = TAIL_CASES["444"]
    planes = [torch.from_numpy(p).to("meta") for p in tail_planes("444")]
    with pytest.raises(ValueError, match="no K3 implementation"):
        fused_tail(planes, modes, chroma, transform, out_h, out_w)

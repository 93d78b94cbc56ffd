"""K4 module of the PyTorch port (jpeg_decoder_tpu_torch/ops/kernels.py
fused_recon, and the probe tools/experiments/fused_recon_probe_torch.py)
against the JAX package's unfused formulation in numpy: the TPU probe's
reference "X", `dequantize_and_idct_blocks_fast` + `blocks_to_plane` +
`ycbcr_to_rgb`, columns cut to the width.

On the CPU `fused_recon` runs its plain PyTorch version. Tolerance:
|diff| <= 3. Both sides are an fp32 IDCT summing the 64 products in their
own order (torch's matmul, numpy's), which may move a pixel across a
rounding boundary by 1; color conversion scales a chroma difference of 1
by up to 1.772, and 1 + 1.772 rounds to at most 3.

The pieces the kernel shares with K2, on the CPU: its folded bases
(`fused_recon_bases`) bit-equal to `params.folded_basis`, and the unfused
path with K2's split-TF32 scheme as its IDCT (`split_tf32_product`) within
3 of the numpy X, as the plain version is. On the card the kernel is
bit-equal to `fused_recon_plain(..., k2=dequant_idct)`
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu.ops.color import ycbcr_to_rgb
from jpeg_decoder_tpu.ops.idct import (blocks_to_plane,
                                       dequantize_and_idct_blocks_fast)
from jpeg_decoder_tpu_torch.ops.kernels import (dequant_idct, fused_recon,
                                                fused_recon_bases,
                                                fused_recon_plain,
                                                split_tf32_product)
from jpeg_decoder_tpu_torch.params import (folded_basis, idct_basis,
                                           quant_table)

from torch_inputs import FIXTURE_DIR, fixture

TOL = 3


def _numpy_x(stores, qts, width):
    bh, bw, _ = stores[0].shape
    planes = [blocks_to_plane(dequantize_and_idct_blocks_fast(
        s.reshape(-1, 64), q, xp=np), bw, bh)[:, :width]
        for s, q in zip(stores, qts)]
    return np.stack(ycbcr_to_rgb(*planes, xp=np), axis=0)


def _port_args(stores, qts):
    return ([torch.from_numpy(np.ascontiguousarray(s)) for s in stores]
            + [torch.stack([quant_table(q, "cpu") for q in qts]),
               idct_basis(8, "cpu")])


def _seeded(bh, bw, seed):
    rng = np.random.default_rng(seed)
    stores = [rng.integers(-300, 300, (bh, bw, 64)).astype(np.int16)
              for _ in range(3)]
    qts = [rng.integers(1, 60, 64).astype(np.uint16) for _ in range(3)]
    return stores, qts


def _image():
    from tools.experiments.fused_recon_probe_torch import image_stores

    return image_stores(fixture("small_444.jpg"))


CASES = ["small_444", "seeded_7x5", "seeded_1x1", "seeded_33x2"]


def _case(case):
    """(stores, qts, width) of one named case."""
    if case == "small_444":
        return _image()
    bw, bh = map(int, case.split("_")[1].split("x"))
    stores, qts = _seeded(bh, bw, seed=bw * 100 + bh)
    return stores, qts, bw * 8 - (bw % 3)      # cut columns on some cases


def _split_tf32_k2(coef, q, basis):
    """K2's arithmetic on the K2 path's folded basis: the scheme K4 now
    shares."""
    return split_tf32_product(coef, q[:, None] * basis)


@pytest.mark.parametrize("case", CASES)
def test_fused_recon_plain_within_3_of_numpy_x(case):
    stores, qts, width = _case(case)
    args = _port_args(stores, qts)
    got = fused_recon(*args, width=width)
    ref = _numpy_x(stores, qts, width)
    bh = stores[0].shape[0]
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == ref.shape == (3, bh * 8, width)
    d = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    print(f"{case}: max |diff| {int(d.max())}, {int((d > 0).sum())} differ")
    assert int(d.max()) <= TOL
    # On the CPU the wrapper is the plain version, with either IDCT.
    torch.testing.assert_close(got, fused_recon_plain(*args, width),
                               rtol=0, atol=0)
    torch.testing.assert_close(got, fused_recon_plain(*args, width,
                                                      k2=dequant_idct),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", CASES)
def test_fused_recon_bases_bit_equal_to_params_folded_basis(case):
    stores, qts, _width = _case(case)
    q, basis = _port_args(stores, qts)[3:]
    bases = fused_recon_bases(q, basis)
    assert bases.dtype == torch.float32 and bases.shape == (3, 64, 64)
    assert bases.is_contiguous()
    for i, qt in enumerate(qts):
        want = folded_basis(qt, 8, "cpu")
        assert torch.equal(bases[i].view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", CASES)
def test_split_tf32_k2_path_within_3_of_numpy_x(case):
    stores, qts, width = _case(case)
    args = _port_args(stores, qts)
    got = fused_recon_plain(*args, width, k2=_split_tf32_k2)
    ref = _numpy_x(stores, qts, width)
    assert tuple(got.shape) == ref.shape
    d = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    print(f"{case}: max |diff| {int(d.max())}, {int((d > 0).sum())} differ")
    assert int(d.max()) <= TOL


def test_fused_recon_default_width_keeps_every_column():
    stores, qts = _seeded(2, 3, seed=5)
    out = fused_recon(*_port_args(stores, qts))
    assert tuple(out.shape) == (3, 16, 24)


@pytest.mark.parametrize("bad,match", [
    ("subsampled", "4:4:4"),
    ("dtype", "int16"),
    ("qts", "qts"),
    ("width", "width"),
])
def test_fused_recon_rejects_non_444_inputs(bad, match):
    stores, qts = _seeded(4, 6, seed=9)
    y, cb, cr, q, basis = _port_args(stores, qts)
    width = 48
    if bad == "subsampled":                 # 4:2:0 chroma stores
        cb, cr = cb[:2, :3].contiguous(), cr[:2, :3].contiguous()
    elif bad == "dtype":
        cb = cb.to(torch.int32)
    elif bad == "qts":
        q = q[:2].contiguous()
    else:
        width = 49
    with pytest.raises(ValueError, match=match):
        fused_recon(y, cb, cr, q, basis, width)


def test_probe_needs_a_card_and_rejects_non_444_images():
    from tools.experiments.fused_recon_probe_torch import image_stores, main

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-card exit cannot occur")
    assert main(["--iters", "1"]) == 1
    with pytest.raises(ValueError, match="4:4:4"):
        image_stores((FIXTURE_DIR / "small_422.jpg").read_bytes())

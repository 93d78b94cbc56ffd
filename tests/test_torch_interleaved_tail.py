"""Kernel T1's wrapper, `ops/kernels.py::interleaved_tail` (block pixels of
every component -> the decoded image: upsampling and color conversion, for
one image, a group or a stripe), on the CPU, where it runs its plain
version `interleaved_tail_plain`. Tolerance 0 throughout: both sides are
the same integer arithmetic.

- Against the JAX package's jnp tail (`blocks_to_plane`,
  `upsample_component`, `color_convert_image` from `jpeg_decoder_tpu/ops/`
  with xp=jnp, under `jax.jit`), on seeded block pixels over
  `torch_inputs.T1_CASES`: every upsampler mode (generic at h_scale and
  v_scale 1-4) with every transform its component count takes (the gray
  crop, NONE, RGB, YCbCr, CMYK, YCCK), IDCT scales 8/4/2/1, odd sizes,
  width-1 and height-1 chroma, groups of 1 and 3 images; the planar
  layout is the interleaved image with its channel axis moved.
- On real geometries (`geometry_from_frame` of every fixture, large_420
  at 1/2, 1/4 and 1/8), against the JAX package's `_reconstruct` under
  `jax.jit` on the same stores, the port's T1 fed the JAX package's exact
  IDCT pixels.
- The stripe form (`TailStripe`: a row offset, plane bases and halos),
  through the port's `make_stripe_pipeline`, against the JAX package's on
  the conftest's 8-device CPU mesh: 2, 4 and 8 stripes, padding stripes,
  h2v2, h1v2, h2v1 and generic chroma, padding rows included.
- Routing: `reconstruct` calls the wrapper once per call (one image, a
  group, the stream, the `Decoder`) and the stripes once per stripe
  (counted with monkeypatch); the wrapper raises on a `meta` tensor and
  on shapes that do not cover the output.
- Every literal constant of `csrc/interleaved_tail.cu` equals its value in
  the host copy's `host/ops/color.py`.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeg_decoder_tpu_torch as jt
import jpeg_decoder_tpu_torch.host.ops.color as host_color
from jpeg_decoder_tpu.ops.color import color_convert_image as ref_color
from jpeg_decoder_tpu.ops.idct import blocks_to_plane as ref_b2p
from jpeg_decoder_tpu.ops.idct import dequantize_and_idct_blocks as ref_idct
from jpeg_decoder_tpu.ops.pipeline import _reconstruct as ref_reconstruct
from jpeg_decoder_tpu.ops.upsample import upsample_component as ref_up
from jpeg_decoder_tpu.parallel.stripes import \
    make_stripe_pipeline as ref_stripe_pipeline
from jpeg_decoder_tpu_torch.host.decoder import Decoder as HostDecoder
from jpeg_decoder_tpu_torch.host.ops.pipeline import geometry_from_frame
from jpeg_decoder_tpu_torch.ops import kernels, pipeline
from jpeg_decoder_tpu_torch.ops.kernels import (TailStripe,
                                                interleaved_tail,
                                                interleaved_tail_plain)
from jpeg_decoder_tpu_torch.params import DeviceParams
from jpeg_decoder_tpu_torch.parallel import make_mesh, stripes
from jpeg_decoder_tpu_torch.parallel.stripes import (_pad_rows,
                                                     make_stripe_pipeline)

from test_torch_batch import _one_torch_thread  # noqa: F401
from test_torch_mesh import _jax_mesh, _ref_geometry
from torch_inputs import (SMALL_FIXTURES, T1_CASES, T1_LAYOUTS, fixture,
                          t1_args, t1_geometry, t1_pixels)

CU = (Path(kernels.__file__).resolve().parent.parent / "csrc"
      / "interleaved_tail.cu")
CASE_IDS = ["-".join(map(str, c)) for c in T1_CASES]


@functools.lru_cache(maxsize=None)
def _jax_tail(geometry):
    """The JAX package's tail of `_reconstruct` (everything after the
    IDCT), jitted for one image of `geometry`: block pixels [n_c, s, s]
    per component -> the image."""
    ref = _ref_geometry(geometry)

    def run(*pixels):
        planes = [ref_b2p(px, c.blocks_wide, c.blocks_high, xp=jnp)
                  for px, c in zip(pixels, ref.components)]
        if ref.transform is None:
            comp = ref.components[0]
            return planes[0][:comp.size_height, :comp.size_width]
        channels = [ref_up(plane, c.upsampler_mode,
                           input_width=c.size_width,
                           input_height=c.size_height,
                           out_rows=ref.out_height, out_width=ref.out_width,
                           h_scale=c.h_scale, v_scale=c.v_scale, xp=jnp)
                    for c, plane in zip(ref.components, planes)]
        return ref_color(channels, ref.transform, xp=jnp)

    return jax.jit(run)


@pytest.mark.parametrize("case", T1_CASES, ids=CASE_IDS)
def test_plain_t1_bit_equal_to_the_jax_tail(case):
    layout, transform, h, w, scale, images = case
    geometry = t1_geometry(layout, h, w, scale, transform)
    pixels = t1_pixels(geometry, images, seed=100 * h + w)
    args = t1_args(geometry)
    got = interleaved_tail(pixels, *args)
    want = np.stack([np.asarray(_jax_tail(geometry)(
        *[px[i].numpy() for px in pixels])) for i in range(images)])
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    planar = interleaved_tail(pixels, *args, planar=True)
    if got.dim() == 4:
        np.testing.assert_array_equal(planar.numpy(),
                                      want.transpose(0, 3, 1, 2))
    else:
        assert torch.equal(planar, got)


def _fixture_geometry(name: str, scale_to=None):
    """`geometry_from_frame` of a fixture's frame, scaled to `scale_to`."""
    d = HostDecoder(fixture(name), backend="numpy")
    if scale_to is None:
        d.read_info()
    else:
        d.scale(*scale_to)
    n = len(d.frame.components)
    return geometry_from_frame(
        d.frame, None if n == 1 else d._determine_color_transform())


REAL = ([(name, None) for name in SMALL_FIXTURES + (
    "tower_420.jpg", "mixed_500x333.jpg", "stripe_420.jpg")]
    + [("large_420.jpg", s) for s in ((1024, 840), (512, 420), (256, 210))])


@pytest.mark.parametrize("name,scale_to", REAL,
                         ids=[f"{n}-{s}" for n, s in REAL])
def test_t1_on_fixture_geometries_equals_jax_reconstruct(name, scale_to):
    geometry = _fixture_geometry(name, scale_to)
    rng = np.random.default_rng(len(name))
    stores, qts = [], []
    for c in geometry.components:
        store = rng.integers(-40, 40, (c.blocks_wide * c.blocks_high, 64))
        store[:, 0] = rng.integers(-800, 800, store.shape[0])
        stores.append(store.astype(np.int16))
        qts.append(rng.integers(1, 9, 64).astype(np.uint16))
    want = jax.jit(lambda s, q: ref_reconstruct(
        _ref_geometry(geometry), s, q, jnp))(tuple(stores), tuple(qts))
    pixels = [torch.from_numpy(np.asarray(ref_idct(
        s, q, c.dct_scale, xp=np)).reshape(1, -1, c.dct_scale, c.dct_scale))
        for s, q, c in zip(stores, qts, geometry.components)]
    got = interleaved_tail(pixels, *t1_args(geometry))[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _stripe_stores(geometry, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(-60, 60, (c.blocks_wide * c.blocks_high, 64))
            .astype(np.int16) for c in geometry.components]


# (layout, transform, height, width, stripes): h2v2 at 2, 4 and 8 stripes,
# the last stripes padding (7 MCU rows over 4 and 8 stripes); h1v2; h2v1;
# generic at v_scale 3 and 4; four components with V2 and H2 in one image.
# Then stripes of 3 MCU rows of 8 (24 rows: row0 and the bases off the
# kernel's 16-row tiles) in h2v1, h1v1 (a short third stripe, a padding
# fourth) and generic at v_scale 1; and h1v2 over 8 stripes of 32 rows, the
# last three padding, whose far row (ih - 1) lies below their near rows.
STRIPES = [
    ("420", "YCBCR", 64, 48, 2), ("420", "YCBCR", 100, 90, 4),
    ("420", "YCBCR", 100, 90, 8), ("440", "YCBCR", 72, 37, 4),
    ("422", "RGB", 40, 33, 4), ("g23", "YCBCR", 100, 41, 4),
    ("g14", "NONE", 65, 19, 2), ("mixed4", "YCCK", 50, 27, 4),
    ("422", "YCBCR", 72, 50, 3), ("444", "YCBCR", 70, 33, 4),
    ("g31", "RGB", 56, 29, 3), ("440", "YCBCR", 150, 140, 8),
]


@pytest.mark.parametrize("case", STRIPES,
                         ids=["-".join(map(str, c)) for c in STRIPES])
def test_stripe_t1_bit_equal_to_the_jax_stripes(case):
    layout, transform, h, w, n = case
    geometry = t1_geometry(layout, h, w, 8, transform)
    v_max = max(f[1] for f in T1_LAYOUTS[layout])
    mcu_rows = -(-h // (8 * v_max))
    stores = _pad_rows(geometry, _stripe_stores(geometry, h + w), mcu_rows,
                       n, False)
    qts = tuple(np.full(64, 2, np.uint16) for _ in stores)
    got = make_stripe_pipeline(geometry, mcu_rows, n,
                               make_mesh({"stripe": n}, ["cpu"] * n))(
        stores, qts)
    want = ref_stripe_pipeline(_ref_geometry(geometry), mcu_rows, n,
                               _jax_mesh({"stripe": n}))(stores, qts)
    assert got.shape == want.shape       # padding rows included
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _spy(monkeypatch, module) -> list:
    """Count the calls of `module.interleaved_tail`."""
    calls = []

    def spy(pixels, *args, **kw):
        calls.append(pixels[0].shape[0])
        return interleaved_tail(pixels, *args, **kw)

    monkeypatch.setattr(module, "interleaved_tail", spy)
    return calls


@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_reconstruct_calls_t1_once(monkeypatch, precision):
    calls = _spy(monkeypatch, pipeline)
    geometry = t1_geometry("420", 33, 47, 8, "YCBCR", precision)
    stores = [torch.from_numpy(np.stack([s] * 3)) for s in
              _stripe_stores(geometry, 5)]
    qts = [tuple(np.full(64, 3, np.uint16) for _ in stores)] * 3
    params = DeviceParams(torch.device("cpu"))
    group = pipeline.reconstruct(geometry, stores, qts, params)
    planar = pipeline.reconstruct(geometry, stores, qts, params, planar=True)
    assert calls == [3, 3]
    assert torch.equal(planar, group.permute(0, 3, 1, 2))
    data = [fixture("tower_420.jpg")] * 3 + [fixture("small_gray.jpg")]
    with jt.DeviceStreamDecoder(device="cpu", precision=precision,
                                host_threads=1) as dec:
        dec.decode_stream(data, batch_size=3)
        assert calls == [3, 3, 3, 1]
        dec.decode_stream(data[:1])
    assert calls == [3, 3, 3, 1, 1]
    jt.Decoder(fixture("small_422.jpg"), precision=precision,
               device="cpu").decode_array()
    assert calls == [3, 3, 3, 1, 1, 1]


def test_stripes_call_t1_once_per_stripe(monkeypatch):
    calls = _spy(monkeypatch, stripes)
    geometry = t1_geometry("420", 100, 90, 8, "YCBCR")
    stores = _pad_rows(geometry, _stripe_stores(geometry, 1), 7, 4, False)
    make_stripe_pipeline(geometry, 7, 4, make_mesh(
        {"stripe": 4}, ["cpu"] * 4))(stores, tuple(
            np.ones(64, np.uint16) for _ in stores))
    assert calls == [1] * 4


def test_t1_raises_on_meta_and_on_shapes_that_do_not_cover():
    geometry = t1_geometry("420", 17, 23, 8, "YCBCR")
    comps, transform, out_h, out_w = t1_args(geometry)
    pixels = t1_pixels(geometry, 1, 0)
    with pytest.raises(ValueError, match="no T1 implementation"):
        interleaved_tail([p.to("meta") for p in pixels], comps, transform,
                         out_h, out_w)
    with pytest.raises(ValueError, match="does not cover"):      # H2 wide
        interleaved_tail(pixels, comps, transform, out_h, 2 * out_w + 8)
    with pytest.raises(ValueError, match="does not cover"):      # V2 tall
        interleaved_tail(pixels, comps, transform, 3 * out_h, out_w)
    with pytest.raises(ValueError, match="no grid"):
        interleaved_tail([pixels[0][:, :-1]] + pixels[1:], comps,
                         transform, out_h, out_w)
    with pytest.raises(ValueError, match="halos"):               # V2 stripe
        interleaved_tail(pixels, comps, transform, 16, out_w,
                         stripe=TailStripe(0, (0, 0, 0), (None,) * 3))
    with pytest.raises(ValueError, match="gray crop"):
        interleaved_tail(pixels, comps, None, out_h, out_w)
    with pytest.raises(ValueError, match="contiguous"):
        interleaved_tail([p.transpose(2, 3) for p in pixels], comps,
                         transform, out_h, out_w)
    with pytest.raises(ValueError, match="empty"):
        interleaved_tail(pixels, comps, transform, 0, out_w)


def test_plain_t1_is_its_own_plain_version_on_the_cpu():
    """On a CPU tensor the wrapper returns exactly what the plain version
    gives, whatever the layout or the stripe form."""
    geometry = t1_geometry("mixed4", 29, 31, 4, "CMYK")
    pixels = t1_pixels(geometry, 2, 9)
    args = t1_args(geometry)
    for planar in (False, True):
        assert torch.equal(interleaved_tail(pixels, *args, planar=planar),
                           interleaved_tail_plain(pixels, *args,
                                                  planar=planar))


# The kernel's named constants and the host copy's values.
CONSTANTS = {
    "kFixed": host_color._FIXED, "kHalf": host_color._HALF,
    "kC1_402": host_color._C1_402, "kC0_344": host_color._C0_344,
    "kC0_714": host_color._C0_714, "kC1_772": host_color._C1_772,
}


def test_kernel_constants_equal_the_host_copy():
    """Every `constexpr int32_t` of the kernel source is listed here and
    equals its value in `host/ops/color.py`; each is used."""
    src = CU.read_text()
    found = dict(re.findall(r"constexpr int32_t (k\w+) = (-?\d+);", src))
    assert {k: int(v) for k, v in found.items()} == CONSTANTS
    for name in CONSTANTS:
        assert len(re.findall(rf"\b{name}\b", src)) >= 2, name

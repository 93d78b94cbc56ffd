"""Port of `__graft_entry__.py::dryrun_multichip` (`:80-150`): the decode
step over an n-device mesh with both parallel axes, each checked end to
end.

`dryrun_multichip(n_devices, devices=None)` splits the n devices into a
"data" x "stripe" mesh (data 2 when n is even, the rest stripes), then:
- DP: a batch of seeded coefficient stores of a 4:2:0 YCbCr geometry over
  "data" (`decode_batch_sharded`);
- SP: one image's MCU rows over "stripe" (`decode_striped`);
- DP x SP (data > 1): the batch, each image striped
  (`decode_striped_batch`);
each bit-equal to the plain reconstruction (the host copy's numpy
`_reconstruct`); then real JPEGs, where the reference reads
`/root/reference`, the committed fixture `tests/fixtures/torch_port/
tower_420.jpg`: `DeviceStreamDecoder(mesh=...)` over the prefix and bits
interchanges, bit-equal to the meshless decoder; the entropy-included
stripes (`decode_striped`, and DP x SP through
`stripe_bits.decode_bits_striped_batch`), bit-equal to the host decode;
and, where `tools/make_torch_fixtures.py` is importable (a checkout), a
lossless (SOF3) stream over the mesh, bit-equal to the host decode.

`devices` defaults to every CUDA device; a caller may repeat one
(["cpu"] * 8 in the CPU tests, ["cuda:0"] * 4 on a machine with one
card). Raises AssertionError on any mismatch.

Under a process group (`dist.init_process_mesh`), `devices` are this
process's and `n_devices` counts the mesh across every process (each
gives n_devices / processes of its devices; the stripe-only mesh takes
sp / processes from each, so its halo and carry cross between
processes). Every process then checks only its own shards, against its
own oracle, and skips the images of the others (`dist.Remote`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..host.ops.color import ColorTransform
from ..host.ops.pipeline import (ComponentGeometry, ImageGeometry,
                                 _reconstruct)
from .batch import decode_batch_sharded
from .dist import Remote, world_size
from .mesh import cuda_devices, make_mesh
from .stripes import decode_striped, decode_striped_batch

TOWER = (Path(__file__).resolve().parents[2] / "tests" / "fixtures"
         / "torch_port" / "tower_420.jpg")


def _example_geometry(mcu_rows: int = 8, mcu_cols: int = 8) -> ImageGeometry:
    """A baseline 4:2:0 YCbCr geometry (the flagship decode shape)."""
    luma = ComponentGeometry(
        blocks_wide=2 * mcu_cols, blocks_high=2 * mcu_rows, dct_scale=8,
        size_width=16 * mcu_cols, size_height=16 * mcu_rows,
        upsampler_mode="h1v1", h_scale=1, v_scale=1)
    chroma = ComponentGeometry(
        blocks_wide=mcu_cols, blocks_high=mcu_rows, dct_scale=8,
        size_width=8 * mcu_cols, size_height=8 * mcu_rows,
        upsampler_mode="h2v2", h_scale=2, v_scale=2)
    return ImageGeometry(
        components=(luma, chroma, chroma),
        out_width=16 * mcu_cols, out_height=16 * mcu_rows,
        transform=ColorTransform.YCBCR)


def _example_inputs(geometry: ImageGeometry, batch: int = 0, seed: int = 0):
    rng = np.random.default_rng(seed)
    stores = []
    for c in geometry.components:
        shape = (c.blocks_high * c.blocks_wide, 64)
        if batch:
            shape = (batch,) + shape
        stores.append(rng.integers(-512, 512, shape).astype(np.int16))
    qts = [rng.integers(1, 64, 64).astype(np.uint16)
           for _ in geometry.components]
    return tuple(stores), tuple(qts)


def _equal(got, want, what: str) -> None:
    """`got` equal to `want`; where `got` is a list of `Shard`s, each equal
    to its slice of `want`."""
    if isinstance(got, list):
        for shard in got:
            _equal(shard.data, np.asarray(want)[shard.index],
                   f"{what} shard {shard.index}")
        return
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = want.cpu().numpy() if isinstance(want, torch.Tensor) else want
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{what} diverged from its reference")


def _equal_images(got: list, want: list, what: str) -> None:
    """Each image of a stream equal to its reference; `Remote` places
    (another process's images) skipped."""
    for i, (y, x) in enumerate(zip(got, want)):
        if not isinstance(y, Remote):
            _equal(y, x, f"{what} image {i}")


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the decode step over an n-device mesh (dp x sp axes) and check
    every part (module docstring). Returns what it ran: the mesh's axis
    sizes and the checks that passed."""
    from ..host.decoder import Decoder
    from ..models.stream import DeviceStreamDecoder, stage_host_bits
    from .stripe_bits import decode_bits_striped_batch

    if devices is None:
        devices = cuda_devices()
    procs = world_size()
    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    sp = n_devices // dp
    if n_devices % procs or sp % procs or len(devices) * procs < n_devices:
        raise AssertionError(f"need {n_devices} devices in {procs} equal "
                             f"parts of at most {len(devices)}, with "
                             f"{sp} stripes among them")
    mesh = make_mesh({"data": dp, "stripe": sp},
                     devices[:n_devices // procs])
    stripe_mesh = make_mesh({"stripe": sp}, devices[:sp // procs])
    checks = []

    geometry = _example_geometry(mcu_rows=max(2 * sp, 8))
    mcu_rows = geometry.components[0].blocks_high // 2

    # DP: a batch over "data".
    batch = 2 * dp
    stores_b, qts = _example_inputs(geometry, batch=batch)
    out = decode_batch_sharded(geometry, list(stores_b), list(qts), mesh,
                               data_axis="data")
    _equal(out, np.stack([_reconstruct(geometry, [s[b] for s in stores_b],
                                       qts, np) for b in range(batch)]),
           "DP batch")
    checks.append("dp")

    # SP: one image's MCU rows over "stripe", with the halo exchange.
    stores, qts = _example_inputs(geometry)
    ref = _reconstruct(geometry, stores, qts, np)
    img = decode_striped(geometry, list(stores), list(qts), stripe_mesh,
                         mcu_rows=mcu_rows)
    _equal(img, ref, "striped decode")
    checks.append("sp")

    # DP x SP over the two-axis mesh.
    if dp > 1:
        stores_b = [np.broadcast_to(s, (dp,) + s.shape).copy()
                    for s in stores]
        combined = decode_striped_batch(geometry, stores_b, list(qts), mesh,
                                        mcu_rows=mcu_rows)
        _equal(combined, np.stack([ref] * dp), "DP x SP batch")
        checks.append("dp x sp")

    # Real JPEGs through the stream decoder on the mesh.
    if TOWER.exists():
        data = TOWER.read_bytes()
        n_imgs = 2 * dp
        dev0 = mesh.first
        for interchange in ("prefix", "bits"):
            with DeviceStreamDecoder(device=dev0, host_threads=2,
                                     interchange=interchange) as plain, \
                    DeviceStreamDecoder(mesh=mesh, host_threads=2,
                                        interchange=interchange) as sharded:
                want = plain.decode_stream([data] * n_imgs)
                got = sharded.decode_stream([data] * n_imgs,
                                            batch_size=n_imgs)
            _equal_images(got, want, f"mesh {interchange} stream")
            checks.append(f"{interchange} stream")

        # The entropy-included stripes: one image, then DP x SP.
        gold = Decoder(data, backend="numpy").decode_array()
        if sp >= 2:
            with DeviceStreamDecoder(mesh=stripe_mesh,
                                     host_threads=2) as dec:
                _equal(dec.decode_striped(data, engine="xla"), gold,
                       "stripe-split bits decode")
            checks.append("stripe bits")
            if dp > 1:
                out_b = decode_bits_striped_batch(
                    [stage_host_bits(data) for _ in range(dp)], mesh)
                if out_b is None:
                    raise AssertionError("DP x SP bits batch declined")
                _equal(out_b, np.stack([gold] * dp), "DP x SP bits batch")
                checks.append("dp x sp bits")

        # Lossless over the mesh, where the checkout's recipe is at hand.
        try:
            from tools.make_torch_fixtures import sof3_jpeg, sof3_samples
        except ImportError:
            sof3_jpeg = None
        if sof3_jpeg is not None:
            ll = sof3_jpeg(sof3_samples(64, 48, 1, 16, 0, seed=3), 6, 0, 16)
            want = Decoder(ll, backend="numpy", precision="exact"
                           ).decode_array()
            with DeviceStreamDecoder(mesh=mesh, host_threads=2) as dec:
                _equal_images(dec.decode_stream([ll] * n_imgs,
                                                batch_size=n_imgs),
                              [want] * n_imgs, "mesh lossless")
            checks.append("lossless stream")
    return {"mesh": dict(mesh.shape), "checks": checks}

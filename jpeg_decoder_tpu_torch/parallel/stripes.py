"""Port of `jpeg_decoder_tpu/parallel/stripes.py`: MCU-row stripe
parallelism, one image's rows over the mesh's "stripe" axis.

The image's MCU rows split into contiguous stripes of k = ceil(mcu_rows /
n) rows, one per device. Dequantize + IDCT is local to a stripe; the only
cross-stripe dependency is the V2 vertical chroma filter, whose far row
can reach one plane row into the neighbouring stripe
(`/root/reference/src/upsampler.rs:174-177`). Each device sends its edge
rows to its neighbours (`mesh.halo_rows`, the reference's `lax.ppermute`),
after which upsampling and color conversion are local again. Output rows
come back one block per stripe and are gathered on one device.

Bit-exactness: every stripe runs the exact int32 IDCT (kernel E1,
`ops/pipeline.py::exact_pixels_batch`, as the reference's stripes run
`dequantize_and_idct_blocks` at any precision) and evaluates the same
integer filter taps over globally indexed near and far rows; padding
stripes (when the MCU rows do not divide evenly) make rows that are
cropped off.

Each stripe's work is enqueued on its own device by one caller: one E1
launch for all of the stripe's components, the halo exchange (the first
and last plane rows of each V2 component, taken from the block pixels by
one small copy), then one T1 launch (`ops/kernels.py::interleaved_tail`
with a `TailStripe`) for upsampling and color. A line of one device
replays all of it, the gather included, as one "stripe_recon" CUDA graph
(`make_stripe_pipeline`, `models/graphs.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..host.ops.upsample import H1V2, H2V2
from ..models import graphs
from ..ops.kernels import TailStripe, interleaved_tail
from ..ops.pipeline import exact_pixels_batch
from ..transfer import put
from .dist import Shard
from .mesh import gather_rows, halo_rows, local_positions


def _edge_rows(px: torch.Tensor, blocks_wide: int) -> torch.Tensor:
    """The first and last plane rows of block pixels [N, n_c, s, s] (a
    grid `blocks_wide` blocks wide): uint8 [N, 2, blocks_wide * s]."""
    n, _, s, _ = px.shape
    return torch.stack([px[:, :blocks_wide, 0], px[:, -blocks_wide:, -1]],
                       dim=1).reshape(n, 2, blocks_wide * s)


def build_stripe_local_recon(geometry, mcu_rows: int, n_stripes: int):
    """The per-stripe reconstruction of `geometry` cut into `n_stripes`
    stripes of ceil(mcu_rows / n_stripes) MCU rows: dequantize + IDCT (one
    E1 launch per stripe), the 1-row V2 chroma halo exchange, upsampling
    and color (one T1 launch per stripe). Returns
    recon(stores, qts_b, params, owners=None) -> list, one uint8
    [N, R, out_w(, C)] per stripe on its device (R the stripe's output
    rows), where stores[d] holds stripe d's per-component int16 [N, k *
    v_i * blocks_wide_i, 64] on its device, qts_b per image its
    per-component uint16[64] tables and params[d] the `DeviceParams` of
    stripe d's device. With `owners` (the rank of each stripe, on a mesh
    across processes) the lists hold this process's stripes only, in
    order, and the halo crosses to the neighbours of other processes. The
    reference's `build_stripe_local_recon` runs inside shard_map over the
    stripe axis; here the lists run along it. Shared by the store-level
    stripe pipeline (`make_stripe_pipeline`) and the entropy-included one
    (`stripe_bits.py`)."""
    comps = geometry.components
    k_mcu = -(-mcu_rows // n_stripes)            # MCU rows per stripe
    v = [c.blocks_high // mcu_rows for c in comps]
    scale = comps[0].dct_scale
    R = k_mcu * max(v) * scale                   # output rows per stripe
    lp = [k_mcu * vi * scale for vi in v]        # plane rows per component
    v2 = [ci for ci, c in enumerate(comps)
          if c.upsampler_mode in (H1V2, H2V2)]

    def recon(stores, qts_b, params, owners=None) -> list:
        at = (range(n_stripes) if owners is None
              else local_positions(owners))
        pixels = [exact_pixels_batch(geometry, stores[j], qts_b, params[j])
                  for j in range(len(at))]
        halos = {ci: halo_rows([_edge_rows(px[ci], comps[ci].blocks_wide)
                                for px in pixels], owners)
                 for ci in v2}
        return [interleaved_tail(
                    pixels[j], comps, geometry.transform, R,
                    geometry.out_width,
                    stripe=TailStripe(d * R, tuple(d * x for x in lp), tuple(
                        halos[ci][j] if ci in halos else None
                        for ci in range(len(comps)))))
                for j, d in enumerate(at)]

    return recon


def _stripe_recon_body(_dec, shape, inputs) -> torch.Tensor:
    """A "stripe_recon" graph's body (`graphs.BodyShape.fn`): the line's
    stripe-local reconstruction on the graph's inputs (each stripe's
    stores, every stripe on the graph's device), the stripes' rows
    gathered: uint8 [b, n * R, W(, C)]."""
    n = shape.line.n_stripes
    recon = build_stripe_local_recon(shape.geometry, shape.line.mcu_rows, n)
    outs = recon([list(w) for w in inputs.wires], inputs.qts_b,
                 [inputs.params] * n)
    return gather_rows(outs, outs[0].device, dim=1)


def _stripe_recon_fill(geometry, mcu_rows: int, n: int, stores: list, qts,
                       cache):
    """One line's stores (per component the line's images' int16
    [b, n * k_i, 64], numpy) landed in their `graphs.stripe_recon_key`'s
    graph of `cache`, each stripe's rows apart, with `qts` (shared by every
    image) once per image, in one H2D submission (a `graphs.Fill`); None at
    the key's first sight on a card."""
    b = stores[0].shape[0]
    key = graphs.stripe_recon_key(geometry, mcu_rows, n, b)
    if cache.first_sight(key):
        return None
    shape = graphs.BodyShape((), len(geometry.components), geometry, b,
                             False, "stripe_recon",
                             line=graphs.StripeLine(mcu_rows, n),
                             fn=_stripe_recon_body)
    wires = [tuple(np.ascontiguousarray(s.reshape(b, n, -1, 64)[:, d],
                                        np.int16)
                   for s in stores) for d in range(n)]
    return cache.fill(key, shape, wires, [], [qts] * b)


def _shards(batch: int, n_data: int) -> list:
    """The reference's `PartitionSpec(data)` split of `batch` rows over
    `n_data` devices: contiguous blocks of ceil(batch / n_data) (a batch
    that does not divide leaves the last blocks short or empty, where the
    reference refuses it). [(first, end), ...] per device."""
    per = -(-batch // n_data)
    return [(min(i * per, batch), min((i + 1) * per, batch))
            for i in range(n_data)]


def make_stripe_pipeline(geometry, mcu_rows: int, n_stripes: int, mesh,
                         stripe_axis: str = "stripe", data_axis: str = None):
    """The striped reconstruction over `mesh`.

    Expects per-component numpy stores padded to ceil(mcu_rows/n) * n MCU
    rows. Returns fn(stores, qts) -> uint8 [n * R, W(, C)] on the mesh's
    first device, the stripes' rows gathered there (R = a stripe's output
    rows).

    With `data_axis` set, the stores carry a leading batch axis split over
    that mesh axis, each image's rows striped over `stripe_axis` (batch DP
    and stripe SP composed; the halo exchanges run along the stripe axis,
    the data axis needs none): fn -> [B, n * R, W(, C)]. `qts` is one
    per-component table tuple shared by every image, as in the
    reference.

    A line whose stripes and the mesh's first device are one device
    in a mesh of one process (`graphs.one_device`) replays its
    `stripe_recon` graph (the process's cache of that device,
    `graphs.device_graphs`) from its key's second call; any other line,
    and a key's first call, dispatches eagerly.

    On a mesh across processes each process reconstructs only the stripes
    it holds, and fn returns its `Shard`s of that result: index (rows,),
    or (images, rows) with `data_axis`, and the stripe's tensor on its
    device."""
    recon = build_stripe_local_recon(geometry, mcu_rows, n_stripes)
    if data_axis is None:
        grid = mesh.axis_devices(stripe_axis)[None]
        lines = mesh.axis_owners(stripe_axis)[None]
    else:
        grid = mesh.axis_devices(data_axis, stripe_axis)
        lines = mesh.axis_owners(data_axis, stripe_axis)
    if grid.shape[1] != n_stripes:
        raise ValueError(f"mesh axis {stripe_axis!r} has {grid.shape[1]} "
                         f"devices, not {n_stripes}")
    spread = mesh.processes > 1

    def run(stores, qts):
        stores = [np.asarray(s) for s in stores]
        if data_axis is None:
            stores = [s[None] for s in stores]
        batch = stores[0].shape[0]
        parts = []
        for devs, line, (b0, b1) in zip(grid, lines,
                                        _shards(batch, len(grid))):
            at = local_positions(line) if spread else range(n_stripes)
            if b1 <= b0 or not at:
                continue
            if graphs.one_device(mesh, devs):
                fill = _stripe_recon_fill(
                    geometry, mcu_rows, n_stripes,
                    [s[b0:b1] for s in stores], qts,
                    graphs.device_graphs(devs[0]))
                if fill is not None:
                    parts.append(fill.run())
                    continue
            local = [[put((np.ascontiguousarray(
                s[b0:b1].reshape(b1 - b0, n_stripes, -1, 64)[:, d]),),
                devs[d])[0] for s in stores]
                for d in at]
            outs = recon(local, [qts] * (b1 - b0),
                         [mesh.params(devs[d]) for d in at],
                         line if spread else None)
            if not spread:
                parts.append(gather_rows(outs, mesh.first, dim=1))
                continue
            for d, o in zip(at, outs):
                rows = slice(d * o.shape[1], (d + 1) * o.shape[1])
                parts.append(Shard((rows,), o[0]) if data_axis is None
                             else Shard((slice(b0, b1), rows), o))
        if spread:
            return parts
        out = torch.cat(parts) if len(parts) > 1 else parts[0]
        return out if data_axis is not None else out[0]

    return run


def _cropped_shards(shards: list, rows: int, cols=None) -> list:
    """Shards of a striped result (index (..., rows)) cut to the image's
    first `rows` output rows and `cols` columns (all when None), as numpy;
    shards of padding rows only are dropped."""
    out = []
    for s in shards:
        r = s.index[-1]
        take = min(r.stop, rows) - r.start
        if take <= 0:
            continue
        lead = (slice(None),) * (len(s.index) - 1)
        out.append(Shard((*s.index[:-1], slice(r.start, r.start + take)),
                         s.data[(*lead, slice(0, take), slice(0, cols))]
                         .cpu().numpy()))
    return out


def _out_size(geometry) -> tuple:
    """(rows, columns or None) of the decoded image: gray crops both."""
    if geometry.transform is None:
        comp = geometry.components[0]
        return comp.size_height, comp.size_width
    return geometry.out_height, None


def _pad_rows(geometry, stores, mcu_rows: int, n: int, batched: bool):
    """Stores padded with zero blocks to ceil(mcu_rows / n) * n MCU rows."""
    k = -(-mcu_rows // n)
    padded = []
    for c, store in zip(geometry.components, stores):
        want = k * n * (c.blocks_high // mcu_rows)
        s = np.asarray(store)
        lead = s.shape[:1] if batched else ()
        blocks = s.reshape(*lead, c.blocks_high, c.blocks_wide, 64)
        if want > c.blocks_high:
            pad = np.zeros((*lead, want - c.blocks_high, c.blocks_wide, 64),
                           np.int16)
            blocks = np.concatenate([blocks, pad], axis=len(lead))
        padded.append(blocks.reshape(*lead, -1, 64))
    return padded


def decode_striped(geometry, stores, qts, mesh, mcu_rows: int,
                   stripe_axis: str = "stripe"):
    """Decode one image with its MCU rows split over `mesh`'s stripe axis.

    stores: np.int16 [blocks_high_i * blocks_wide_i, 64] per component (the
    full grids); qts: np.uint16[64] per component. Returns the np.uint8
    image cropped to the geometry's output size; on a mesh across
    processes, this process's `Shard`s of it (numpy, cropped)."""
    n = mesh.shape[stripe_axis]
    fn = make_stripe_pipeline(geometry, mcu_rows, n, mesh, stripe_axis)
    out = fn(_pad_rows(geometry, stores, mcu_rows, n, False),
             tuple(np.asarray(q) for q in qts))
    rows, cols = _out_size(geometry)
    if mesh.processes > 1:
        return _cropped_shards(out, rows, cols)
    return out.cpu().numpy()[:rows, :cols]


def decode_striped_batch(geometry, stores_batched, qts, mesh, mcu_rows: int,
                         data_axis: str = "data",
                         stripe_axis: str = "stripe"):
    """A batch of same-geometry images, each striped: DP x SP.

    stores_batched: np.int16 [B, blocks_high_i * blocks_wide_i, 64] per
    component. Returns np.uint8 [B, ...] cropped to the geometry's output
    size; on a mesh across processes, this process's `Shard`s of it."""
    n = mesh.shape[stripe_axis]
    fn = make_stripe_pipeline(geometry, mcu_rows, n, mesh, stripe_axis,
                              data_axis=data_axis)
    out = fn(_pad_rows(geometry, stores_batched, mcu_rows, n, True),
             tuple(np.asarray(q) for q in qts))
    rows, cols = _out_size(geometry)
    if mesh.processes > 1:
        return _cropped_shards(out, rows, cols)
    return out.cpu().numpy()[:, :rows, :cols]

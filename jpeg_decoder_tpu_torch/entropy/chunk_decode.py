"""Device half of the bits interchange: delta-wire unpack and the chunk
Huffman decode (kernel K1).

Mirrors `jpeg_decoder_tpu/entropy/pallas_decode.py`:
- `unpack_delta` is the vector part of `unpack_delta_classes`: entry bits
  by a cumsum of the 23-bit deltas, block bases by an exclusive cumsum of
  the budgets (kernel U1, `csrc/unpack_delta.cu`, on a CUDA tensor: one
  launch, a CTA per tile of `U1_TILE` entries, the tiles' prefixes by
  decoupled look-back over a status buffer of its own, whose epoch comes
  from the host, or from the buffer itself inside a captured graph's body
  (`_build.graph_scope`); its plain version `unpack_delta_plain` on a CPU
  tensor).
- `decode_chunks` replaces `build_pallas_sweep` and its kernel
  `_build_decode_kernel`, and returns the same `nat` tensor: int16
  [n_blocks, 64] natural-order coefficients in stream block order, DC
  columns holding wrap16 differences.

K1 takes its per-chunk inputs from either wire: the 4 B/chunk delta wire
(`ab`, `base` from `unpack_delta`), or the 12 B/chunk anchor wire that
ships `ab`, the meta word and `base` as they are (the inputs of the
reference's XLA engine, `device_scan.py::build_anchored_decoder`), for
scans `pack_delta` declines. The anchor wire takes up to 8 table rows (4
distinct (DC, AC) pairs, as SOF1 allows) and any symbol count per chunk.

What the port leaves out, and why: the class partition (argsort),
`materialize_slots`, the one-hot dense emission, pack16 and the rowmap all
exist because Mosaic gathers and scatters slowly. On the GPU every chunk
reads the stream at its own bit offset: one thread walks it, keeping the
decoder state every few symbols, and threads decode the segments between
those checkpoints in parallel, storing straight into `nat`. So the chunks
stay in stream order and no partition is needed: budget-0 entries (the
terminator and the padding) decode nothing. Codes of up to 11 bits resolve
through lookahead tables (`params.lookahead_tables` for the decode,
`params.walk_tables`, two symbols at a time, for the walk), longer ones
through the maxcode chain.

`decode_chunks` dispatches on the device of its inputs: CPU tensors run
`decode_chunks_plain`, CUDA tensors launch the CUDA kernel
(`csrc/huffman_decode.cu`), anything else raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ..params import LUT_SIZE, MAX_PATTERN, ScanTables

U1_TILE = 8192      # entries a CTA of U1 takes: kThreads * kPer of
                    # csrc/unpack_delta.cu
MAX_TABS = 8        # table rows: 4 (DC, AC) pairs, the most SOF1 selects
# A chunk holds at most 31 blocks (the meta word's 5-bit budget) of at most
# 64 symbols each, so no chunk needs more steps. On the GPU s_max is only a
# loop bound; the delta wire keeps the Pallas limit of 224 by itself.
S_MAX_LIMIT = 31 * 64


def unpack_delta(dm: torch.Tensor):
    """4 B/chunk delta wire (pallas_decode.pack_delta), int32 [n] -> per
    entry (ab, base), each int32 [n]: ab = cumsum(dm >>> 9) is the entry
    bit, base = cumsum(budget) - budget the first stream block, budget =
    (dm >>> 4) & 31. CPU tensors run `unpack_delta_plain`, CUDA tensors
    kernel U1 (one launch; none for an empty wire), anything else
    raises."""
    if dm.device.type == "cpu":
        return unpack_delta_plain(dm)
    if dm.device.type != "cuda":
        raise ValueError(f"no U1 implementation for device {dm.device}")
    if dm.dtype != torch.int32 or dm.dim() != 1 or not dm.is_contiguous():
        raise ValueError(f"dm must be contiguous int32 [n], got {dm.dtype} "
                         f"{tuple(dm.shape)}")
    ab, base = _u1_outputs(dm)
    if dm.numel():
        lib = _build.load()
        with torch.cuda.device(dm.device):
            stream = torch.cuda.current_stream(dm.device).cuda_stream
            status, epoch = None, 0
            tiles = -(-dm.numel() // U1_TILE)
            if tiles > 1:
                status, epoch = _build.status_buffer(
                    "unpack_delta", dm.device, stream, 2 * tiles, 30)
            err = _u1_launch(lib, dm, ab, base, status, epoch, stream)
            _build.count_launch("unpack_delta")
        _build.check(lib, err, "unpack_delta")
    return ab, base


def _u1_outputs(dm: torch.Tensor) -> tuple:
    """U1's (ab, base): the rows of one [2, n rounded up to 4] allocation,
    so both start on a 16-byte boundary."""
    n = dm.numel()
    out = torch.empty((2, -(-n // 4) * 4), dtype=torch.int32,
                      device=dm.device)
    return out[0, :n], out[1, :n]


def _u1_launch(lib, dm, ab, base, status, epoch: int, stream) -> int:
    """One `jdt_unpack_delta` call (the kernel's launch), its error code;
    `status` None for a wire of one tile."""
    return lib.jdt_unpack_delta(
        dm.data_ptr(), dm.numel(), ab.data_ptr(), base.data_ptr(),
        None if status is None else status.data_ptr(),
        0 if status is None else status.numel() - 1, epoch, stream)


def unpack_delta_plain(dm: torch.Tensor):
    """Plain PyTorch version of U1. The shifts are logical: the wire word
    is widened to int64 and masked to 32 bits. pack_delta refuses streams
    of 2^26 words or more, so ab fits int32."""
    u = dm.to(torch.int64) & 0xFFFFFFFF
    budget = (u >> 4) & 31
    ab = torch.cumsum(u >> 9, 0)
    base = torch.cumsum(budget, 0) - budget
    return ab.to(torch.int32), base.to(torch.int32)


def _check_inputs(words, dm, ab, base, tables: ScanTables, s_max: int,
                  n_blocks: int) -> None:
    dev = words.device
    for name, t in (("words", words), ("dm", dm), ("ab", ab), ("base", base),
                    ("maxcode", tables.maxcode), ("delta", tables.delta),
                    ("values", tables.values), ("lut", tables.lut),
                    ("walk", tables.walk), ("pattern", tables.pattern),
                    ("unzig", tables.unzig)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, words on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if words.dim() != 1 or dm.dim() != 1:
        raise ValueError("words and dm must be 1-D")
    if ab.shape != dm.shape or base.shape != dm.shape:
        raise ValueError(f"ab {tuple(ab.shape)} / base {tuple(base.shape)} "
                         f"must match dm {tuple(dm.shape)}")
    n_tab = tables.n_tab
    if not 1 <= n_tab <= MAX_TABS or tables.maxcode.shape != (n_tab, 16) \
            or tables.delta.shape != (n_tab, 16) \
            or tables.values.shape != (n_tab, 64) \
            or tables.lut.shape != (n_tab, LUT_SIZE) \
            or tables.walk.shape != (n_tab, LUT_SIZE):
        raise ValueError(f"tables must be [n_tab<={MAX_TABS}, 16] / "
                         f"[n_tab, 16] / [n_tab, 64] / [n_tab, {LUT_SIZE}]")
    if not 1 <= tables.pattern.numel() <= MAX_PATTERN:
        raise ValueError(f"pattern length {tables.pattern.numel()} not in "
                         f"1..{MAX_PATTERN}")
    if tables.unzig.shape != (64,):
        raise ValueError("unzig must be [64]")
    if not 1 <= s_max <= S_MAX_LIMIT:
        raise ValueError(f"s_max {s_max} not in 1..{S_MAX_LIMIT}")
    if n_blocks < 0 or n_blocks * 64 >= 2 ** 31:
        raise ValueError(f"n_blocks {n_blocks} out of range")


def decode_chunks(words, dm, ab, base, tables: ScanTables, s_max: int,
                  n_blocks: int, out: torch.Tensor = None) -> torch.Tensor:
    """Decode every chunk of one scan into nat, int16 [n_blocks, 64].

    words: int32 [n_words] big-endian stream words (uint32 bit patterns),
    zero-padded past the last chunk (pack_delta pads WORDS_PAD words; the
    kernel also reads 0 past `n_words`). dm: int32 per-chunk words whose
    low 9 bits are `budget << 4 | slot` (the delta wire's, or the anchor
    wire's meta word); ab (entry bit, a uint32 bit pattern), base (first
    stream block): from `unpack_delta(dm)` or shipped on the anchor wire.
    Stops each chunk after `s_max` symbol steps or when its budget of
    blocks is done. Blocks outside [0, n_blocks) are not stored: a stripe's
    first chunk may begin before the stripe (`parallel/stripe_bits.py`,
    base < 0). The kernel writes every row of `nat` itself (no zero fill
    first), which needs the chunks' first blocks `base` to be
    nondecreasing, as both wires and the stripe wire make them.

    `out`: where to write nat instead of a new tensor, contiguous int16
    [n_blocks, 64] on the words' device (a view of a larger tensor, such as
    one image's rows of a stripe's [b, n_blocks, 64]); it is returned."""
    _check_inputs(words, dm, ab, base, tables, s_max, n_blocks)
    if out is not None and (
            out.dtype != torch.int16 or out.shape != (n_blocks, 64)
            or not out.is_contiguous() or out.device != words.device
            or out.data_ptr() % 16):
        raise ValueError(f"out must be contiguous int16 [{n_blocks}, 64] on "
                         f"{words.device} on a 16-byte boundary, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if words.device.type == "cpu":
        return decode_chunks_plain(words, dm, ab, base, tables, s_max,
                                   n_blocks, out)
    if words.device.type != "cuda":
        raise ValueError(f"no K1 implementation for device {words.device}")
    nat = out if out is not None else torch.empty(
        (n_blocks, 64), dtype=torch.int16, device=words.device)
    lib = _build.load()
    with torch.cuda.device(words.device):
        err = lib.jdt_huffman_decode(
            words.data_ptr(), words.numel(),
            dm.data_ptr(), ab.data_ptr(), base.data_ptr(), dm.numel(),
            tables.maxcode.data_ptr(), tables.delta.data_ptr(),
            tables.values.data_ptr(), tables.lut.data_ptr(),
            tables.walk.data_ptr(), tables.n_tab,
            tables.pattern.data_ptr(), tables.pattern.numel(),
            tables.unzig.data_ptr(), s_max, nat.data_ptr(), n_blocks,
            torch.cuda.current_stream(words.device).cuda_stream)
        _build.count_launch("huffman_decode")
    _build.check(lib, err, "huffman_decode")
    return nat


def decode_chunks_plain(words, dm, ab, base, tables: ScanTables, s_max: int,
                        n_blocks: int, out: torch.Tensor = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of K1: the same state machine, vectorized over
    chunks, one step of every chunk at a time. All bit arithmetic runs in
    int64 on 32-bit patterns, so shifts are logical as in the kernel. Runs
    on any device; the CPU tests and `chip_smoke.py`'s on-card comparison
    use it. `out` as `decode_chunks` takes it (the result copied there)."""
    dev = words.device
    i64 = torch.int64
    w = words.to(i64) & 0xFFFFFFFF
    n_words = w.numel()
    u = dm.to(i64) & 0xFFFFFFFF
    budget = (u >> 4) & 31
    slot = u & 15
    p = ab.to(i64) & 0xFFFFFFFF
    blk0 = base.to(i64)
    n = u.numel()
    k = torch.zeros(n, dtype=i64, device=dev)
    blk = torch.zeros(n, dtype=i64, device=dev)

    maxcode = tables.maxcode.to(i64)
    delta = tables.delta.to(i64)
    vw = tables.values.to(i64) & 0xFFFFFFFF
    values = ((vw[:, :, None] >> (8 * torch.arange(4, device=dev)))
              & 0xFF).reshape(vw.shape[0], 256)
    pattern = torch.zeros(MAX_PATTERN, dtype=i64, device=dev)
    plen = tables.pattern.numel()
    pattern[:plen] = tables.pattern.to(i64)
    unzig = tables.unzig.to(i64)
    shifts = 16 - torch.arange(1, 17, device=dev)          # 16 - L

    sink = n_blocks * 64                                   # dropped stores
    flat = torch.zeros(sink + 1, dtype=torch.int16, device=dev)

    def read(idx):
        ok = idx < n_words
        return torch.where(ok, w[idx.clamp(max=n_words - 1)], 0)

    for _ in range(s_max):
        active = blk < budget
        widx = p >> 5
        b = p & 31
        w0 = read(widx)
        w1 = read(widx + 1)
        win = torch.where(b == 0, w0,
                          ((w0 << b) | (w1 >> (32 - b))) & 0xFFFFFFFF)
        win16 = win >> 16

        is_dc = k == 0
        tab = pattern[slot] * 2 + (~is_dc).to(i64)
        run_fail = torch.cumprod(
            ((win16[:, None] >> shifts) > maxcode[tab]).to(i64), dim=1)
        length = (1 + run_fail.sum(1)).clamp(max=16)
        code = win16 >> (16 - length)
        vidx = (code + delta[tab, length - 1]).clamp(0, 255)
        value = values[tab, vidx]

        r = value >> 4
        s = value & 15
        mag = torch.where(is_dc, value, s)
        magm = mag.clamp(1, 31)
        mshift = (32 - length - magm).clamp(min=0)
        mbits = (win >> mshift) & ((1 << magm) - 1)
        half = 1 << (magm - 1)
        ext = torch.where(mbits < half, mbits - 2 * half + 1, mbits)
        ext = torch.where(mag == 0, 0, ext)

        is_zrl = ~is_dc & (s == 0) & (r == 15)
        is_eob = ~is_dc & (s == 0) & (r != 15)
        kc = torch.where(is_dc, 0, (k + r).clamp(max=63))
        blk_abs = blk0 + blk
        # A stripe's first chunk may start before the stripe (a negative
        # base): its lead-in blocks belong to the stripe above and are
        # dropped, as the kernel drops them (index_put_ would wrap them).
        emits = (active & (is_dc | (~is_zrl & ~is_eob))
                 & (blk_abs >= 0) & (blk_abs < n_blocks))
        idx = torch.where(emits, blk_abs * 64 + unzig[kc], sink)
        flat.index_put_((idx,), (ext & 0xFFFF).to(torch.int16))  # wraps

        k_next = torch.where(is_dc, 1, torch.where(
            is_zrl, k + 16, torch.where(is_eob, 64, k + r + 1)))
        done = active & (is_eob | (k_next >= 64))
        p = p + torch.where(active, length + mag, 0)
        k = torch.where(active, torch.where(done, 0, k_next), k)
        blk = blk + done.to(i64)
        slot_next = slot + done.to(i64)
        slot = torch.where(slot_next >= plen, 0, slot_next)
    nat = flat[:sink].view(n_blocks, 64)
    return nat if out is None else out.copy_(nat)

"""The benchmark's inputs: they repeat by seed, and what the encoders write
decodes, through the port's plain path and its host oracle, to exactly
what the plain reference works out from the generator's own data."""

import numpy as np
import pytest
import torch

from portbench.gen import bitpack, photo
from portbench.reference import baseline

PHOTO = {"width": 70, "height": 46, "quality": 90,
         "size_classes": [{"scan_bytes": [0, 1 << 30], "noise": 2.9}]}


def _naive_pack(values, nbits) -> bytes:
    bits = "".join(format(int(v), f"0{int(n)}b") for v, n in
                   zip(values, nbits) if n)
    bits += "1" * (-len(bits) % 8)
    raw = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    return raw.replace(b"\xff", b"\xff\x00")


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_pack_matches_a_bit_string(seed):
    rng = np.random.default_rng(seed)
    nbits = rng.integers(1, 33, 500)
    values = rng.integers(0, 1 << 32, 500, dtype=np.uint64) \
        & ((np.uint64(1) << nbits.astype(np.uint64)) - np.uint64(1))
    assert bitpack.pack(values, nbits) == _naive_pack(values, nbits)


def test_categories():
    cat, extra = bitpack.categories(np.array([0, 1, -1, 2, -3, 1023, -1024]))
    assert cat.tolist() == [0, 1, 1, 2, 2, 10, 11]
    assert extra.tolist() == [0, 1, 0, 2, 0, 1023, 1023]


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 12345, 2 ** 64 + 3])
def test_inputs_repeat_by_seed(seed):
    a = photo.generate(PHOTO, {"pool": 3}, seed)
    b = photo.generate(PHOTO, {"pool": 3}, seed)
    c = photo.generate(PHOTO, {"pool": 3}, seed + 1)
    assert [x["jpeg"] for x in a] == [x["jpeg"] for x in b]
    assert len({x["jpeg"] for x in a}) == 3        # a pool of distinct images
    assert all(x["jpeg"] != y["jpeg"] for x, y in zip(a, c))


def _port_decode(datas, batch, precision="exact"):
    from jpeg_decoder_tpu_torch import DeviceStreamDecoder
    with DeviceStreamDecoder(device="cpu", precision=precision) as dec:
        return dec.decode_stream(datas, batch_size=batch)


@pytest.mark.parametrize("size", [(46, 70), (16, 16), (33, 17)])
def test_photo_port_and_oracle_equal_the_reference(size):
    from jpeg_decoder_tpu_torch.host.decoder import Decoder
    cfg = {**PHOTO, "height": size[0], "width": size[1]}
    pool = photo.generate(cfg, {"pool": 3}, 99)
    refs = [baseline.expected(it, cfg, "cpu") for it in pool]
    outs = _port_decode([it["jpeg"] for it in pool], batch=3)
    for it, ref, out in zip(pool, refs, outs):
        assert ref.shape == (size[0], size[1], 3)
        assert torch.equal(out, ref)
        host = np.asarray(Decoder(it["jpeg"], backend="numpy").decode_array())
        assert np.array_equal(host, ref.numpy())
    # The control (the program's fast tier) departs from the reference.
    fast = _port_decode([it["jpeg"] for it in pool], batch=3, precision="fast")
    assert max(int((f.int() - r.int()).abs().max())
               for f, r in zip(fast, refs)) > 0


def test_photo_size_classes():
    """Photo i takes size class i % classes: its grain is stepped until its
    entropy-coded bytes lie in the class, on every seed."""
    sizes = [it["scan_bytes"] for it in photo.generate(PHOTO, {"pool": 6}, 4)]
    mid = sorted(sizes)[3]
    classes = [{"scan_bytes": [mid - 200, mid + 200], "noise": 2.9},
               {"scan_bytes": [2 * mid - 400, 2 * mid + 400], "noise": 2.9}]
    cfg = {**PHOTO, "size_classes": classes}
    for seed in (4, 2 ** 40 + 1):
        pool = photo.generate(cfg, {"pool": 4}, seed)
        for i, it in enumerate(pool):
            lo, hi = classes[i % 2]["scan_bytes"]
            assert lo <= it["scan_bytes"] <= hi
    with pytest.raises(ValueError):
        photo.photo({**PHOTO, "size_classes": [
            {"scan_bytes": [1, 2], "noise": 2.9}]}, 4, 0)


def test_photo_sizes_from_the_stream():
    cfg = {**PHOTO, "height": 46, "width": 70}
    it = photo.photo(cfg, 5, 0)
    data = it["jpeg"]
    sos = data.index(b"\xff\xda")
    header = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    assert it["scan_bytes"] == len(data) - 2 - header
    assert it["blocks"] == 3 * 5 * 4 + 2 * 3 * 5      # 4:2:0, 3 x 5 MCUs
    assert it["out_bytes"] == 46 * 70 * 3

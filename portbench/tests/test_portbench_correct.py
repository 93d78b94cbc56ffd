"""`correct` comes out true for the program and false for the control and
for each fault a cell can have, with the timed path broken underneath a
whole run (here at a small size, on the CPU):
- a call that returns its state unchanged (the last call's outputs), from
  the first call on or only once the early samples have passed;
- half of a group left out (its first half returned twice);
- an answer altered where it is produced (one element of one image).
No cell spans chips, so no exchange can be left out."""

import pytest
import torch

from jpeg_decoder_tpu_torch.models.stream import DeviceStreamDecoder

from conftest import small_run

CELLS = ("photo-large.exact-b8",)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = small_run(name)
    assert res["correct"] and res["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"setup_s"}     # the card's time: a card
    assert res["device"]["memory_peak_bytes"] == 0          # no card


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    res = small_run(name, control=True)
    assert not res["correct"]
    assert res["checks"]["max_abs_diff"]["value"] >= 1


def _stale(real):
    last = {}

    def fake(self, *args):
        out = real(self, *args)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    return fake


def _stale_late(real):
    """`_stale` from the call after the warm-up's (3 a call input, then 2
    cycles) and the early samples' first 4 cycles, of 4 inputs."""
    count = [0]
    stale = _stale(real)

    def fake(self, *args):
        count[0] += 1
        return stale(self, *args) if count[0] > 4 * (3 + 2 + 4) \
            else real(self, *args)
    return fake


def _half(real):
    def fake(self, kind, group, *args):
        n = (len(group) + 1) // 2
        out = real(self, kind, group[:n], *args)
        return (out * 2)[:len(group)]
    return fake


def _altered(real):
    def fake(self, *args):
        out = real(self, *args)
        first = out[0] if isinstance(out, list) else out
        wide = first.to(torch.int32)
        wide.view(-1)[0] ^= 1                 # flip the first element's low bit
        bumped = wide.to(first.dtype)
        return [bumped] + list(out[1:]) if isinstance(out, list) else bumped
    return fake


@pytest.mark.parametrize("name,method,fault", [
    ("photo-large.exact-b8", "_grouped", _stale),
    ("photo-large.exact-b8", "_decode_group", _stale),
    ("photo-large.exact-b8", "_decode_group", _stale_late),
    ("photo-large.exact-b8", "_decode_group", _half),
    ("photo-large.exact-b8", "_decode_group", _altered)])
def test_fault_is_not_correct(monkeypatch, name, method, fault):
    monkeypatch.setattr(DeviceStreamDecoder, method,
                        fault(getattr(DeviceStreamDecoder, method)))
    res = small_run(name)
    assert not res["correct"], res["checks"]


def test_control_on_the_card(cuda):
    """The controls at a size a test run holds, on the card."""
    for name in CELLS:
        assert small_run(name, device="cuda")["correct"]
        assert not small_run(name, device="cuda", control=True)["correct"]

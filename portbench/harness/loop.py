"""The measured window: a closed loop with a fixed number of calls in flight.

`call(k)` enqueues call k's device work and returns its outputs (tensors
whose work may still run on the card). Behind each call the loop records a
CUDA event; before issuing call k it waits for call k - `in_flight`'s
event (`Event.synchronize`, which drops the interpreter lock) and drops
that call's outputs, so call k + `in_flight` is issued only once call k is
complete, and no output is held past the next issue. A call's completion
is its event's time on the card, put on the host clock through an event
recorded on the idle card as the window opens: the completion times need
no thread of their own and nothing the host does late shifts them.

A call is sampled by its index, or as the first call of a given input
issued once a given time into the window has passed (a late sample). A
sampled call's outputs are copied, as its completion is taken, into
page-locked host buffers made before the window, on a stream of their own
(a few ms of the copy engine and of the issuing thread, for a handful of
calls a window), and dropped: no output outlives the next issue, so the
memory the window holds is the program's alone.

On the CPU (tests) a call is complete when it returns.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


@dataclasses.dataclass
class Window:
    """What a window did: per call its start and completion (host clock,
    seconds) and its images; the window's start and length; the sampled
    calls' outputs on the host ({call: [tensors]}); the late samples'
    calls ({input: call}); the error a call raised (None if none did)."""
    starts: list
    dones: list
    images: list
    t0: float
    seconds: float
    kept: dict
    late: dict = dataclasses.field(default_factory=dict)
    error: BaseException = None

    @property
    def calls(self) -> int:
        return len(self.starts)

    def images_done(self) -> int:
        """Images whose call completed inside the window."""
        end = self.t0 + self.seconds
        return sum(n for d, n in zip(self.dones, self.images)
                   if d is not None and d <= end)

    def per_second(self) -> list:
        """Images completed in each whole second of the window."""
        out = [0] * int(self.seconds)
        for d, n in zip(self.dones, self.images):
            i = int(d - self.t0) if d is not None else -1
            if 0 <= i < len(out):
                out[i] += n
        return out


def _keep(outs: list, bufs, stream) -> list:
    """Host copies of a sampled call's outputs: into `bufs` (page-locked,
    shaped as the warm-up's outputs) on `stream`, else a plain copy."""
    bufs = bufs or []
    kept = []
    with torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext():
        for i, o in enumerate(outs):
            buf = bufs[i] if i < len(bufs) else None
            if buf is not None and buf.shape == o.shape \
                    and buf.dtype == o.dtype:
                kept.append(buf.copy_(o, non_blocking=True))
            else:               # not what the warm-up returned
                kept.append(o.to("cpu", copy=True))
    if stream is not None:
        stream.synchronize()
    return kept


def run(call, seconds: float, in_flight: int, sample: dict,
        device: torch.device, span=None, max_calls: int = None,
        late: dict = None, inputs: int = 1, stream=None) -> Window:
    """Issue calls 0, 1, ... for `seconds` from the first call's start (or
    `max_calls` of them), `in_flight` at a time, and wait for every call
    issued. `sample`: {call: the host tensors its outputs are copied into
    (None on the CPU: cloned)}; `late`: {input: (seconds into the window,
    host tensors)}, the first call of that input (call k takes input k %
    `inputs`) issued from then on sampled as well. `span(name)`: a context
    manager around the waits for a call's completion, or None; `stream`:
    the stream of the sampled calls' copies (a new one if None)."""
    cuda = device.type == "cuda"
    wait = span or (lambda _name: contextlib.nullcontext())
    win = Window([], [], [], 0.0, seconds, {})
    sample = dict(sample)
    late = late or {}
    if cuda and stream is None:
        stream = torch.cuda.Stream(device)
    pending: list = []          # (call, event, outputs), oldest first
    ends: list = []
    if cuda:
        torch.cuda.synchronize(device)
        ref = torch.cuda.Event(enable_timing=True)
        ref.record()
        t_ref = time.perf_counter()

    def complete(item):
        k, event, outs = item
        if event is not None:
            with wait("portbench.wait"):
                event.synchronize()
        else:
            win.dones[k] = time.perf_counter()
        if k in sample:
            with wait("portbench.keep"):
                win.kept[k] = _keep(outs, sample[k], stream)

    try:
        k = 0
        while True:
            if len(pending) >= in_flight:
                complete(pending.pop(0))
            start = time.perf_counter()
            if k == 0:
                win.t0 = start
            elif start >= win.t0 + seconds or k == max_calls:
                break
            g = k % inputs
            if g in late and g not in win.late \
                    and start >= win.t0 + late[g][0]:
                win.late[g] = k
                sample[k] = late[g][1]
            outs = call(k)
            event = None
            if cuda:
                event = torch.cuda.Event(enable_timing=True)
                event.record()
            win.starts.append(start)
            win.dones.append(None)
            win.images.append(len(outs))
            ends.append(event)
            pending.append((k, event, outs))
            del outs
            k += 1
        while pending:
            complete(pending.pop(0))
    except Exception as e:          # reported once the program is freed
        win.error = e
        pending.clear()
    if cuda and win.error is None:
        for i, event in enumerate(ends):
            win.dones[i] = t_ref + ref.elapsed_time(event) / 1e3
    return win

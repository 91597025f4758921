"""The host-to-device staging stage of the pipelined PUT, the counterpart
of minio_tpu's HostFeed (minio_tpu/ops/rs_pallas.py).

Run as a stage of pipeline.Pipeline, `HostFeed` moves each batch's H2D
copy onto its own thread and its own copy stream: the copy of batch N+1
runs while the card computes batch N and the host writes batch N-1. The
batch comes from a pinned buffer (pipeline.host_buffer), so the copy is
a true asynchronous DMA; the stage records an event after it and hands
on a `Staged` item (the device tensor and the event). The compute
stream waits on that event on the device (`wait_event`), never the host.

minio_tpu's HostFeed also takes a mesh sharding and an accept gate; they
serve the mesh engine, which the port does not have yet.

`H2D` counts the copies to the card by kind, pinned or pageable, where
the port makes them: here, in the device engine's `_stage` for callers
outside the pipeline, and in the shard readers' fetches.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..utils.device import resolve_device

H2D = {"pinned": 0, "pageable": 0, "pinned_bytes": 0, "pageable_bytes": 0}
_h2d_lock = threading.Lock()


def count_h2d(pinned: bool, nbytes: int) -> None:
    kind = "pinned" if pinned else "pageable"
    with _h2d_lock:
        H2D[kind] += 1
        H2D[kind + "_bytes"] += nbytes


def h2d_snapshot() -> dict:
    with _h2d_lock:
        return dict(H2D)


def reset_h2d() -> None:
    with _h2d_lock:
        for k in H2D:
            H2D[k] = 0


class Staged:
    """A batch on its way to the device: `tensor` lives on the device and
    is valid once `event` (None on the CPU) has completed on the stream
    that consumes it."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor: torch.Tensor, event):
        self.tensor = tensor
        self.event = event

    @property
    def nbytes(self) -> int:
        return self.tensor.numel() * self.tensor.element_size()

    def consume(self) -> torch.Tensor:
        """The tensor, ready for work queued next on the calling thread's
        current stream: that stream waits on the copy's event, and the
        tensor is recorded on it so the caching allocator does not hand
        its memory out again before that work is done."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.tensor.device)
            stream.wait_event(self.event)
            self.tensor.record_stream(stream)
        return self.tensor


class HostFeed:
    """Pipelined H2D stage: pinned host batch -> Staged. With
    device="cpu" the host tensor passes through (the caller asked for
    the CPU). On the card a batch that is not pinned is refused: the
    stage exists to make the copy asynchronous."""

    name = "h2d"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._stream = None
        self._lock = threading.Lock()

    def _copy_stream(self) -> torch.cuda.Stream:
        with self._lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            return self._stream

    def __call__(self, batch) -> Staged:
        t = batch if isinstance(batch, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(batch))
        if self.device.type == "cpu":
            return Staged(t, None)
        if not t.is_pinned():
            raise ValueError("HostFeed stages pinned host buffers only")
        stream = self._copy_stream()
        with torch.cuda.stream(stream):
            dev = t.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        count_h2d(True, t.numel())
        return Staged(dev, event)

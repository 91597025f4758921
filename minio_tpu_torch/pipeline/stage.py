"""Stage: one named step of a streaming pipeline, the counterpart of
minio_tpu/pipeline/stage.py.

A stage is a callable `fn(item) -> item` run by the executor on its own
worker thread, reading from a bounded input queue and writing to a
bounded output queue. Returning `SKIP` drops the item (filter
semantics); raising cancels the whole pipeline (first error wins).
Ordering, backpressure, cancellation and the per-stage counters live in
the executor, so every stage gets them for free.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


class _Token:
    """Identity-compared control tokens that never collide with a
    payload item."""

    __slots__ = ("_name",)

    def __init__(self, name: str):
        self._name = name

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{self._name}>"


# Flows through the queues after the last payload item; each worker
# forwards it downstream exactly once and exits.
END_OF_STREAM = _Token("end-of-stream")
# Returned by a stage fn to drop the current item.
SKIP = _Token("skip")
# Returned by the queue helpers when the pipeline was cancelled mid-wait.
CANCELLED = _Token("cancelled")


@dataclass
class Stage:
    """One pipeline step.

    name      -- label of the stage's counters.
    fn        -- item -> item transform; SKIP drops, raise cancels.
    bytes_of  -- optional item -> int for the stage's byte counter,
                 taken on the stage's OUTPUT.
    """

    name: str
    fn: Callable
    bytes_of: Callable | None = None
    # Filled by the executor per run, so callers can read a finished
    # pipeline's per-stage numbers.
    stats: "StageStats" = field(default_factory=lambda: StageStats())


@dataclass
class StageStats:
    """Per-run counters of one stage, flushed into pipeline.metrics when
    a run finishes."""

    items: int = 0
    bytes: int = 0
    busy_s: float = 0.0   # time inside fn
    wait_s: float = 0.0   # time blocked on the input queue (starved)
    stall_s: float = 0.0  # time blocked on the output queue (backpressured)
    errors: int = 0

    def as_dict(self) -> dict:
        return {
            "items": self.items,
            "bytes": self.bytes,
            "busy_s": round(self.busy_s, 6),
            "wait_s": round(self.wait_s, 6),
            "stall_s": round(self.stall_s, 6),
            "errors": self.errors,
        }

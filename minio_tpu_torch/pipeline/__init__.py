"""Staged streaming pipeline, the counterpart of minio_tpu/pipeline/:
stages connected by bounded queues with backpressure, a recycling buffer
pool (with pinned host buffers for the card), a thread-per-stage
executor with first-error cancellation and deterministic draining, and
per-stage counters. The erasure drivers run on it: PUT (md5, pack, H2D,
dispatch, flush-write) and GET (shard-read, decode).

The admission governors (`admission.py`) hold the encode and decode
slots. minio_tpu's worker pool (`workers.py`) is not ported yet.
"""

from .admission import AdmissionGovernor, client_context, governor
from .buffers import (
    COPY,
    BufferPool,
    copy_add,
    host_buffer,
    pinned_factory,
    shared_pool,
)
from .executor import Pipeline, PipelineCancelled
from .metrics import (
    get_registry,
    pool_stats_snapshot,
    set_registry,
    stage_stats_snapshot,
)
from .stage import END_OF_STREAM, SKIP, Stage

__all__ = [
    "AdmissionGovernor",
    "BufferPool",
    "COPY",
    "copy_add",
    "END_OF_STREAM",
    "host_buffer",
    "Pipeline",
    "PipelineCancelled",
    "client_context",
    "governor",
    "pinned_factory",
    "SKIP",
    "Stage",
    "get_registry",
    "pool_stats_snapshot",
    "set_registry",
    "shared_pool",
    "stage_stats_snapshot",
]

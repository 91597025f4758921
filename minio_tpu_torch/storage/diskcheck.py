"""Hung-drive tolerance knobs, the part of minio_tpu/storage/diskcheck.py
that the erasure fan-outs read: `RobustConfig`, the process-wide
`ROBUST` and `robust_overrides`. minio_tpu's per-drive health tracker
(`DiskHealth`, `MetricsDisk`) is not ported yet, nor the knobs that only
it reads (`enabled`, `breaker_threshold`, `probe_interval_s`,
`max_inflight`).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass


@dataclass
class RobustConfig:
    """Process-wide hung-drive tolerance knobs (minio_tpu's config
    subsystem `drive`). One mutable instance, `ROBUST`, is what the
    writer and reader fan-outs read."""

    op_deadline_s: float = 30.0
    long_op_deadline_s: float = 120.0
    hedge_delay_s: float = 0.15
    straggler_grace_s: float = 2.0


ROBUST = RobustConfig()


@contextmanager
def robust_overrides(**kw):
    """Temporarily override ROBUST fields (tests, what-if runs)."""
    old = {k: getattr(ROBUST, k) for k in kw}
    for k, v in kw.items():
        setattr(ROBUST, k, v)
    try:
        yield ROBUST
    finally:
        for k, v in old.items():
            setattr(ROBUST, k, v)

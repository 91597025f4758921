"""Pipeline counters, the counterpart of minio_tpu/pipeline/metrics.py:
per-stage totals and pool statistics flushed once a run, read back with
stage_stats_snapshot() and pool_stats_snapshot().

The registry hook stays None until the port has a metrics endpoint;
set_registry() installs one with inc() and set_gauge().
"""

from __future__ import annotations

import threading

_mu = threading.Lock()
_registry = None

# Totals per (pipeline, stage) and per pool since process start.
_stage_totals: dict[tuple[str, str], dict] = {}
_pool_totals: dict[str, dict] = {}


def set_registry(registry) -> None:
    global _registry
    with _mu:
        _registry = registry


def get_registry():
    with _mu:
        return _registry


def record_run(pipeline_name: str, stages, error: bool) -> None:
    """Flush one finished run's per-stage stats (the executor calls this
    once a run, on success, error or cancellation)."""
    reg = get_registry()
    if reg is not None:
        reg.inc("pipeline_runs_total", pipeline=pipeline_name)
        if error:
            reg.inc("pipeline_errors_total", pipeline=pipeline_name)
    with _mu:
        for st in stages:
            s = st.stats
            tot = _stage_totals.setdefault((pipeline_name, st.name), {
                "items": 0, "bytes": 0, "busy_s": 0.0, "wait_s": 0.0,
                "stall_s": 0.0, "errors": 0, "runs": 0,
            })
            tot["items"] += s.items
            tot["bytes"] += s.bytes
            tot["busy_s"] += s.busy_s
            tot["wait_s"] += s.wait_s
            tot["stall_s"] += s.stall_s
            tot["errors"] += s.errors
            tot["runs"] += 1
    if reg is None:
        return
    for st in stages:
        s = st.stats
        labels = {"pipeline": pipeline_name, "stage": st.name}
        reg.inc("pipeline_stage_items_total", s.items, **labels)
        reg.inc("pipeline_stage_bytes_total", s.bytes, **labels)
        reg.inc("pipeline_stage_busy_seconds_total", s.busy_s, **labels)
        reg.inc("pipeline_stage_wait_seconds_total", s.wait_s, **labels)
        reg.inc("pipeline_stage_stall_seconds_total", s.stall_s, **labels)
        reg.inc("pipeline_stage_errors_total", s.errors, **labels)


def record_queue_depth(pipeline_name: str, stage_name: str,
                       depth: int) -> None:
    reg = get_registry()
    if reg is not None:
        reg.set_gauge("pipeline_queue_depth", depth,
                      pipeline=pipeline_name, stage=stage_name)


def record_pool(pool) -> None:
    """Mirror a BufferPool's counters (the executor flushes once a run)."""
    stats = pool.stats()
    with _mu:
        _pool_totals[pool.name] = stats
    reg = get_registry()
    if reg is not None:
        reg.set_gauge("pipeline_buffer_pool_allocated", stats["allocated"],
                      pool=pool.name)
        reg.set_gauge("pipeline_buffer_pool_reused_total", stats["reused"],
                      pool=pool.name)


def stage_stats_snapshot(pipeline_name: str | None = None) -> dict:
    """Per-(pipeline, stage) totals since process start, keyed
    "pipeline/stage"."""
    with _mu:
        return {f"{p}/{s}": dict(v) for (p, s), v in _stage_totals.items()
                if pipeline_name is None or p == pipeline_name}


def pool_stats_snapshot() -> dict:
    with _mu:
        return {k: dict(v) for k, v in _pool_totals.items()}

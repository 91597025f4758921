"""Request spans, the port's copy of minio_tpu/observability/spans.py:
the plane that splits a request's host time ("this PUT took 300 ms")
into where it went ("240 ms of it in the admission queue").

- Trace context: a contextvar pair set at the S3 dispatch
  (api/server.py, beside the admission identity): the request's
  `TraceCtx` (trace id and span-id allocator) and the current parent
  span id. Spans nest by swapping the parent var, so the stack is per
  thread, and a trace handed to another thread (`capture()` /
  `activate()` / `bound()`) never races that thread's nesting.
- Fixed-size records in per-thread rings: a finished span appends one
  tuple `(trace, id, parent, kind, label, start_ns, dur_ns, thread)` to
  its thread's ring (RING_RECORDS slots, single writer, no lock). Rings
  are kept by thread ident, and a recycled ident reuses its ring.
- Slow-request exemplars: a request slower than the threshold
  (MTPU_TRACE_SLOW_MS in ms; unset or `auto` tracks a running p99 of
  recent requests) has its records gathered from the rings into a tree
  (at most MAX_TREE_SPANS spans) kept in a store of SLOW_STORE_CAP,
  which the admin `slow-requests` route serves.
- Export: every span observes `mtpu_span_seconds{kind=...}` when a
  registry is installed. Each tree carries the deltas of the engines'
  STATS counters over the request (device dispatches, hedged reads,
  detached stragglers).

Spans time the host: a kernel launch returns before the card finishes,
so the device time shows up in whichever span waits on its result.

The plane is on unless MTPU_TRACE is 0 (or off, false, no): then
`request_trace` makes no context and every record site costs one
contextvar read. `set_trace_hub` is the hook for streaming trees to
trace subscribers; the port has no trace hub yet, so nothing sets it.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import sys
import threading
import time
from collections import deque

# The port's package name, for the engines' modules in sys.modules.
_PKG = __name__.rsplit(".", 2)[0]

# Span series contributed to the metrics_v2 descriptor catalog.
SPAN_DESCRIPTORS: list[tuple[str, str, str]] = [
    ("span_seconds", "histogram",
     "Request-span latency by span kind (admission/stage/worker/"
     "fanout/disk/request)"),
    ("trace_slow_captures_total", "counter",
     "Slow-request span trees captured into the exemplar store"),
]

RING_RECORDS = 1024        # per-thread ring slots (fixed-size records)
SLOW_STORE_CAP = 64        # retained slow-request exemplars
P99_WINDOW = 512           # request durations feeding the auto threshold
P99_RECALC_EVERY = 32      # recompute cadence (finishes per recompute)
MAX_TREE_SPANS = 2048      # exemplar size bound (ring scan result cap)

_metrics = None  # guarded-by: _metrics_mu
_metrics_mu = threading.Lock()
_hub = None  # a trace hub for ?spans=true streaming; none in the port yet


def set_metrics(registry) -> None:
    global _metrics
    with _metrics_mu:
        _metrics = registry


def _reg():
    with _metrics_mu:
        return _metrics


def set_trace_hub(hub) -> None:
    """Install the TraceHub that span trees stream through when a
    subscriber asked for them (`mc admin trace` with ?spans=true)."""
    global _hub
    _hub = hub


def enabled() -> bool:
    """Read per request so tests/operators flip the plane without a
    restart (same convention as MTPU_WORKER_POOL)."""
    return os.environ.get("MTPU_TRACE", "").lower() not in (
        "0", "off", "false", "no"
    )


# ---------------------------------------------------------------------------
# per-thread record rings

class _Ring:
    """Single-writer ring of fixed-size span records. The buffer is a
    preallocated list mutated in place (no structural changes), so the
    slow-capture scan may read a racy snapshot from another thread
    without locks or iteration errors."""

    __slots__ = ("buf", "n")

    def __init__(self, cap: int = RING_RECORDS):
        self.buf: list = [None] * cap
        self.n = 0

    def append(self, rec: tuple) -> None:
        i = self.n
        self.buf[i % len(self.buf)] = rec
        self.n = i + 1

    def snapshot(self) -> list:
        return [r for r in self.buf if r is not None]


_tls = threading.local()
# thread ident -> ring (idents recycle)     # guarded-by: _rings_mu
_rings: dict[int, _Ring] = {}  # guarded-by: _rings_mu
_rings_mu = threading.Lock()

# thread ident -> (trace_id, label): what each thread is serving RIGHT
# NOW — the sampling profiler tags hot stacks with these so a flame
# points back at concrete requests. Plain dict ops are GIL-atomic.
_active: dict[int, tuple[int, str]] = {}


def _ring() -> _Ring:
    try:
        return _tls.ring
    except AttributeError:
        ident = threading.get_ident()
        with _rings_mu:
            ring = _rings.get(ident)
            if ring is None:
                # A recycled ident means its previous thread is dead:
                # reuse the ring (bounds the registry at peak thread
                # count even under per-stream pipeline thread churn).
                ring = _Ring()
                _rings[ident] = ring
        _tls.ring = ring
        return ring


def active_trace(thread_ident: int) -> tuple[int, str] | None:
    """(trace_id, request label) the thread is serving, for the
    profiler's hot-stack attribution; None when idle/untraced."""
    return _active.get(thread_ident)


def any_active() -> bool:
    return bool(_active)


# ---------------------------------------------------------------------------
# trace context

_trace_ids = itertools.count(1)


class TraceCtx:
    """One request's trace: the id, a process-unique span-id allocator
    (itertools.count — safe under concurrent stage threads), and the
    request-entry metadata the exemplar/stream entry carries."""

    __slots__ = ("trace_id", "label", "meta", "start_ns", "root_id",
                 "_ids", "stats0", "error")

    def __init__(self, label: str, meta: dict | None = None):
        self.trace_id = next(_trace_ids)
        self.label = label
        self.meta = meta or {}
        self.start_ns = time.monotonic_ns()
        self._ids = itertools.count(1)
        self.root_id = next(self._ids)
        self.stats0 = _engine_stats()
        self.error = ""

    def alloc(self) -> int:
        return next(self._ids)

    @property
    def hex_id(self) -> str:
        return f"{self.trace_id:08x}"


_trace_var: contextvars.ContextVar = contextvars.ContextVar(
    "mtpu_trace", default=None
)
_parent_var: contextvars.ContextVar = contextvars.ContextVar(
    "mtpu_span_parent", default=0
)


def current() -> TraceCtx | None:
    return _trace_var.get()


def capture():
    """Snapshot (ctx, parent-span-id) for handing to another thread
    (pipeline stages, fan-out pool workers); None when untraced."""
    ctx = _trace_var.get()
    if ctx is None:
        return None
    return (ctx, _parent_var.get())


class activate:
    """Install a captured trace context in the current thread for the
    duration of the block; no-op for a None carrier."""

    __slots__ = ("_carrier", "_t1", "_t2", "_tid")

    def __init__(self, carrier):
        self._carrier = carrier

    def __enter__(self):
        c = self._carrier
        if c is None:
            self._t1 = None
            return self
        ctx, parent = c
        self._t1 = _trace_var.set(ctx)
        self._t2 = _parent_var.set(parent)
        self._tid = threading.get_ident()
        _active[self._tid] = (ctx.trace_id, ctx.label)
        return self

    def __exit__(self, *exc):
        if self._t1 is not None:
            _active.pop(self._tid, None)
            _parent_var.reset(self._t2)
            _trace_var.reset(self._t1)
        return False


def bound(carrier, fn):
    """Wrap `fn` so it runs under the captured trace context — the
    shape fan-out code submits to thread pools."""
    if carrier is None:
        return fn

    def run(*args, **kwargs):
        with activate(carrier):
            return fn(*args, **kwargs)

    return run


# ---------------------------------------------------------------------------
# recording

def _observe(kind: str, dur_ns: int) -> None:
    reg = _reg()
    if reg is not None:
        reg.observe("span_seconds", dur_ns / 1e9, kind=kind)


def record(kind: str, label: str, dur_ns: int,
           start_ns: int | None = None) -> None:
    """Record one finished leaf span under the current parent (the
    shape for sites that already measured their own duration: executor
    stage timings, disk-op wrappers, and zero-duration event marks like
    hedge/straggler-detach)."""
    ctx = _trace_var.get()
    if ctx is None:
        return
    now = time.monotonic_ns()
    if start_ns is None:
        start_ns = now - dur_ns
    _ring().append((
        ctx.trace_id, ctx.alloc(), _parent_var.get(), kind, label,
        start_ns, dur_ns, threading.current_thread().name,
    ))
    _observe(kind, dur_ns)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def relabel(self, label: str) -> None:
        pass


_NULL = _NullSpan()


class _Span:
    __slots__ = ("_ctx", "kind", "label", "_sid", "_token", "_t0")

    def __init__(self, ctx: TraceCtx, kind: str, label: str):
        self._ctx = ctx
        self.kind = kind
        self.label = label

    def relabel(self, label: str) -> None:
        self.label = label

    def __enter__(self):
        self._sid = self._ctx.alloc()
        self._token = _parent_var.set(self._sid)
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        end = time.monotonic_ns()
        _parent_var.reset(self._token)
        _ring().append((
            self._ctx.trace_id, self._sid, _parent_var.get(), self.kind,
            self.label, self._t0, end - self._t0,
            threading.current_thread().name,
        ))
        _observe(self.kind, end - self._t0)
        return False


def span(kind: str, label: str = ""):
    """Nested span context manager; cheap no-op outside a trace."""
    ctx = _trace_var.get()
    if ctx is None:
        return _NULL
    return _Span(ctx, kind, label)


# ---------------------------------------------------------------------------
# slow-request exemplar store + auto threshold

_slow_mu = threading.Lock()
_slow_store: deque = deque(maxlen=SLOW_STORE_CAP)  # guarded-by: _slow_mu
_durations_ms: deque = deque(maxlen=P99_WINDOW)    # guarded-by: _slow_mu
_finish_count = 0                                  # guarded-by: _slow_mu
_auto_threshold_ms = float("inf")                  # guarded-by: _slow_mu
MIN_AUTO_SAMPLES = 32


def slow_threshold_ms() -> float:
    """Effective capture threshold: numeric MTPU_TRACE_SLOW_MS wins;
    unset/'auto' tracks the running p99 (infinite until enough
    samples exist to call anything an outlier)."""
    raw = os.environ.get("MTPU_TRACE_SLOW_MS", "auto").strip().lower()
    if raw and raw != "auto":
        try:
            return float(raw)
        except ValueError:
            pass
    # guardedby-ok: racy read of an atomically-rebound float — a
    # one-recalc-stale threshold misclassifies at most one request
    return _auto_threshold_ms


def _note_duration(dur_ms: float) -> None:
    global _finish_count, _auto_threshold_ms
    with _slow_mu:
        _durations_ms.append(dur_ms)
        _finish_count += 1
        if (_finish_count % P99_RECALC_EVERY == 0
                and len(_durations_ms) >= MIN_AUTO_SAMPLES):
            win = sorted(_durations_ms)
            _auto_threshold_ms = win[min(len(win) - 1,
                                         int(0.99 * len(win)))]


def _collect_tree(ctx: TraceCtx) -> list[dict]:
    """Scan every thread ring for the trace's records and return them
    as span dicts, root first. Best-effort by design: a ring that
    wrapped under heavy concurrency loses that thread's oldest spans,
    never correctness."""
    with _rings_mu:
        rings = list(_rings.values())
    spans: list[dict] = []
    for ring in rings:
        for rec in ring.snapshot():
            if rec[0] != ctx.trace_id:
                continue
            spans.append({
                "id": rec[1], "parent": rec[2], "kind": rec[3],
                "label": rec[4],
                "start_us": (rec[5] - ctx.start_ns) // 1000,
                "duration_us": rec[6] // 1000,
                "thread": rec[7],
            })
            if len(spans) >= MAX_TREE_SPANS:
                # Hard bound on the whole entry, not per ring.
                spans.sort(key=lambda s: (s["start_us"], s["id"]))
                return spans
    spans.sort(key=lambda s: (s["start_us"], s["id"]))
    return spans


def _engine_stats() -> dict:
    """Dispatch and robustness counters from the engines' STATS, read
    only from modules already imported (a request never imports one)."""
    out: dict = {}
    st = sys.modules.get(_PKG + ".erasure.streaming")
    if st is not None:
        out["hedged_reads"] = st.STATS.get("hedged_reads_total", 0)
        out["fanout_stragglers"] = st.STATS.get(
            "fanout_stragglers_total", 0)
    de = sys.modules.get(_PKG + ".erasure.device_engine")
    if de is not None:
        out["device_dispatches"] = de.STATS.get("dispatches", 0)
    return out


def _finish(ctx: TraceCtx) -> None:
    end = time.monotonic_ns()
    dur_ns = end - ctx.start_ns
    # The request itself is a span: the root every child hangs off.
    _ring().append((
        ctx.trace_id, ctx.root_id, 0, "request", ctx.label,
        ctx.start_ns, dur_ns, threading.current_thread().name,
    ))
    _observe("request", dur_ns)
    dur_ms = dur_ns / 1e6
    threshold = slow_threshold_ms()
    _note_duration(dur_ms)
    hub = _hub
    want_stream = hub is not None and getattr(hub, "any_spans", False)
    if dur_ms < threshold and not want_stream:
        return
    stats1 = _engine_stats()
    entry = {
        "trace_id": ctx.hex_id,
        "api": ctx.label,
        "duration_ms": round(dur_ms, 3),
        "time_ns": time.time_ns(),
        "error": ctx.error,
        "stats": {
            k: stats1.get(k, 0) - ctx.stats0.get(k, 0) for k in stats1
        },
        "spans": _collect_tree(ctx),
    }
    entry.update(ctx.meta)
    if dur_ms >= threshold:
        with _slow_mu:
            _slow_store.append(entry)
        reg = _reg()
        if reg is not None:
            reg.inc("trace_slow_captures_total")
    if want_stream:
        hub.publish_spans(dict(entry, type="spans"))


class request_trace:
    """Root span for one request, entered at S3 handler dispatch. Not
    reentrant by design: a request already carrying a trace (internal
    self-calls) keeps the OUTER trace.

    Streaming responses: the handler RETURNS before the body streams
    (decode runs inside the response writer), so the API layer calls
    `defer()` before the handler scope closes and re-enters the same
    trace with `resume(rt)` around the body-stream callable — the root
    span then covers the whole request, dispatch through last byte."""

    __slots__ = ("_label", "_meta", "_tok_t", "_tok_p", "_ctx", "_tid",
                 "deferred", "_io_holder", "_identity")

    def __init__(self, label: str, **meta):
        self._label = label
        self._meta = meta
        self._ctx = None
        self.deferred = False
        self._io_holder = None
        self._identity = None

    def defer(self) -> None:
        """Skip finish at scope exit; `resume` finishes instead.

        Beyond the span ctx, this captures the handler phase's byte-flow
        ledger holder and admission identity (client, bucket): the body
        stream runs on the writer's thread after the handler scope, and
        its contexts, exit, and the decode and verify bytes it moves
        must land in the ledger under this request's op tag and in the
        governor under this caller, not as untagged or anonymous. Both
        are captured here, so resume() needs no hand-built wrapper
        (with tracing disabled too)."""
        self.deferred = True
        # Lazy imports: spans must stay cheap to import and cycle-free.
        from . import ioflow as _ioflow
        from ..pipeline.admission import identity as _adm_identity

        self._io_holder = _ioflow.capture()
        self._identity = _adm_identity()

    def __enter__(self) -> TraceCtx | None:
        if not enabled() or _trace_var.get() is not None:
            return None
        ctx = TraceCtx(self._label, self._meta)
        self._ctx = ctx
        self._tok_t = _trace_var.set(ctx)
        self._tok_p = _parent_var.set(ctx.root_id)
        self._tid = threading.get_ident()
        _active[self._tid] = (ctx.trace_id, ctx.label)
        return ctx

    def __exit__(self, exc_type, exc, tb):
        ctx = self._ctx
        if ctx is None:
            return False
        if exc_type is not None:
            ctx.error = exc_type.__name__
            self.deferred = False  # no stream will run; finish now
        _active.pop(self._tid, None)
        _parent_var.reset(self._tok_p)
        _trace_var.reset(self._tok_t)
        if self.deferred:
            return False
        try:
            _finish(ctx)
        # except-ok: tracing must never fail a request — a broken
        # exemplar capture drops one trace, never a response
        except Exception:  # noqa: BLE001
            pass
        return False


class resume:
    """Re-enter a deferred request_trace for the response-stream phase
    and finish it when the stream completes (or dies).

    Re-entry covers all three planes defer() captured: the span ctx
    (when tracing recorded one), the byte-flow ledger op-tag holder,
    and the admission (client, bucket) identity. The latter two install
    even when the span ctx is None — a disabled trace plane must never
    cost the ledger its op classification or the governor its caller."""

    __slots__ = ("_rt", "_tok_t", "_tok_p", "_tid", "_io_ctx", "_adm_ctx")

    def __init__(self, rt: request_trace):
        self._rt = rt
        self._tok_t = None
        self._io_ctx = None
        self._adm_ctx = None

    def __enter__(self):
        rt = self._rt
        if not rt.deferred:
            return None
        from . import ioflow as _ioflow

        self._io_ctx = _ioflow.activate(rt._io_holder)  # None-safe
        self._io_ctx.__enter__()
        if rt._identity is not None:
            from ..pipeline.admission import client_context

            self._adm_ctx = client_context(rt._identity[0],
                                           bucket=rt._identity[1])
            self._adm_ctx.__enter__()
        ctx = rt._ctx
        if ctx is None:
            return None
        self._tok_t = _trace_var.set(ctx)
        self._tok_p = _parent_var.set(ctx.root_id)
        self._tid = threading.get_ident()
        _active[self._tid] = (ctx.trace_id, ctx.label)
        return ctx

    def __exit__(self, exc_type, exc, tb):
        if self._io_ctx is None:  # not deferred: full no-op
            return False
        if self._tok_t is not None:
            ctx = self._rt._ctx
            if exc_type is not None and not ctx.error:
                ctx.error = exc_type.__name__
            _active.pop(self._tid, None)
            _parent_var.reset(self._tok_p)
            _trace_var.reset(self._tok_t)
            try:
                _finish(ctx)
            # except-ok: tracing must never fail a request — a broken
            # exemplar capture drops one trace, never a response
            except Exception:  # noqa: BLE001
                pass
        self._rt.deferred = False
        if self._adm_ctx is not None:
            self._adm_ctx.__exit__(exc_type, exc, tb)
        self._io_ctx.__exit__(exc_type, exc, tb)
        return False


# ---------------------------------------------------------------------------
# introspection (admin endpoint, tests, bench)

def slow_requests(n: int = SLOW_STORE_CAP) -> list[dict]:
    """Most recent slow-request exemplars, newest last."""
    with _slow_mu:
        return list(_slow_store)[-n:]


def clear_slow_requests() -> int:
    with _slow_mu:
        n = len(_slow_store)
        _slow_store.clear()
        return n


def reset() -> None:
    """Test hook: drop rings, exemplars, and the auto-threshold state
    (never called on the request path)."""
    global _finish_count, _auto_threshold_ms
    with _rings_mu:
        # Live threads keep their _tls.ring reference: empty the rings
        # in place instead of dropping them from the registry.
        for ring in _rings.values():
            ring.buf = [None] * len(ring.buf)
            ring.n = 0
    with _slow_mu:
        _slow_store.clear()
        _durations_ms.clear()
        _finish_count = 0
        _auto_threshold_ms = float("inf")
    _active.clear()

"""Fan-out policy for shard I/O, the counterpart of minio_tpu/utils/
fanout.py.

`SINGLE_CORE` picks the serial drivers: on a one-core host, handing
local (syscall-only) per-drive work to a thread pool buys no parallelism
and costs a dispatch per task, and stage threads only add hand-offs.
Tests force either choice by setting `fanout.SINGLE_CORE`; the drivers
read it at each call. `QuorumFanout` is the quorum-wait and detach
protocol of the shard-write fan-out. `encode_slot` and `decode_slot`
are the admission governors' front doors, `heal_slot` every heal's token
from the heal pacer.
"""

from __future__ import annotations

import io
import os
import threading
import time

from ..observability import carry as obs_carry
from ..observability import spans

SINGLE_CORE = (os.cpu_count() or 1) == 1

# Late straggler outcomes discarded after detach: the slot already holds
# its timeout and heal repairs the shard, but the drop itself is
# counted, so a drive that keeps finishing just past the grace window
# stays visible; a registry installed at server start mirrors the counts
# onto the metrics endpoint.
LATE_DROPS = {"errors": 0, "results": 0}  # guarded-by: _late_mu
_late_mu = threading.Lock()
_metrics = None


def set_metrics(registry) -> None:
    global _metrics
    _metrics = registry


def _note_late_drop(err) -> None:
    key = "errors" if err is not None else "results"
    with _late_mu:
        LATE_DROPS[key] += 1
    if _metrics is not None:
        _metrics.inc(f"fanout_late_dropped_{key}_total")


# The admission deadline of an encode slot, as minio_tpu reads it (the
# governor reads its own from the environment when it is built).
ENCODE_SLOT_DEADLINE_S = float(
    os.environ.get("MTPU_ENCODE_SLOT_DEADLINE_S", "30"))


def encode_slot():
    """Bounded fair admission of an encode stream (PUT, multipart part):
    a waiter times out to a retriable 503 (ErrOperationTimedOut), a full
    queue rejects at once, and one hot client cannot starve the rest
    (the governor's round-robin grant order)."""
    from ..pipeline.admission import governor

    return governor().slot()


def decode_slot():
    """The read-side twin: every erasure GET's decode and verify passes
    the read governor, its own slot pool (2 per core by default), so
    GET clients get the same caps, fairness and 503s as PUT clients, and
    neither plane can starve the other."""
    from ..pipeline.admission import read_governor

    return read_governor().slot()


def heal_slot():
    """Every object heal's read and re-encode section takes a token from
    the heal pacer's background budget: it yields while the admission
    backlog or the foreground disk p99 is high, and is always granted
    within the pace deadline, so pressure slows the MRF drain and never
    wedges it. A heal takes no admission slot."""
    from ..background.healpace import pacer

    return pacer().heal_slot()


def prestart(pool, n: int, timeout_s: float = 60.0) -> None:
    """Start `n` of a ThreadPoolExecutor's workers now (at most its
    ceiling): `n` tasks that wait for one another, so the pool spawns a
    thread for each. A server does it when it starts, so a request finds
    the threads (their stacks and allocator arenas) already there."""
    n = min(n, pool._max_workers)
    barrier = threading.Barrier(n + 1)
    futs = [pool.submit(barrier.wait, timeout_s) for _ in range(n)]
    barrier.wait(timeout_s)
    for f in futs:
        f.result()


def is_local_sink(sink) -> bool:
    """A sink whose write() is a local syscall or memory operation (a
    file, a BytesIO): safe to run inline on one core."""
    return (hasattr(sink, "fileno")
            or isinstance(sink, (io.BytesIO, io.BufferedWriter)))


class StragglerCompensator:
    """Keeps a fan-out ThreadPoolExecutor's healthy capacity constant
    while detached stragglers occupy its workers, possibly for ever: each
    parked straggler raises the pool's worker ceiling by one, and its
    return lowers it again. Growth is capped at `max_extra`."""

    def __init__(self, pool, max_extra: int = 256):
        # Relies on ThreadPoolExecutor._max_workers being read on every
        # submit; a no-op if a later CPython renames it.
        self._pool = pool if hasattr(pool, "_max_workers") else None
        self._max_extra = max_extra
        self._extra = 0     # guarded-by: _mu
        self._applied = 0   # guarded-by: _mu
        self._mu = threading.Lock()

    def _apply(self):  # guarded-by: _mu
        want = min(self._extra, self._max_extra)
        delta = want - self._applied
        if delta and self._pool is not None:
            self._pool._max_workers += delta
        self._applied = want

    def parked(self):
        with self._mu:
            self._extra += 1
            self._apply()

    def released(self):
        with self._mu:
            self._extra -= 1
            self._apply()


def quorum_wait(cv, pending, count_ok, quorum, deadline_s, grace_s):
    """Block on `cv` until count_ok() reaches `quorum` and one straggler
    grace has passed, the fan-out can no longer reach quorum (fail, but
    only after one grace, so tasks about to settle still report), every
    task finished, or deadline_s elapsed. count_ok runs under cv.
    Whatever is left in `pending` afterwards is the caller's to detach.
    The wait is one request span (kind "fanout", "quorum-wait"), so a
    PUT held by a straggling drive puts the stall on the fan-out."""
    with spans.span("fanout", "quorum-wait"):
        _quorum_wait(cv, pending, count_ok, quorum, deadline_s, grace_s)


def _quorum_wait(cv, pending, count_ok, quorum, deadline_s, grace_s):
    deadline = time.monotonic() + deadline_s
    grace_end = None
    fail_end = None
    with cv:
        while pending:
            now = time.monotonic()
            ok = count_ok()
            if ok >= quorum:
                if grace_end is None:
                    grace_end = now + grace_s
                if now >= grace_end:
                    break
                cv.wait(grace_end - now)
            elif ok + len(pending) < quorum:
                if fail_end is None:
                    fail_end = now + grace_s
                if now >= fail_end:
                    break
                cv.wait(fail_end - now)
            elif now >= deadline:
                break
            else:
                cv.wait(deadline - now)


class QuorumFanout:
    """The detach state machine around quorum_wait: dispatch attempt(i)
    for every index in `pending` on the pool (and `inline` ones on the
    caller's thread), wait for quorum plus grace, then detach whatever is
    still in flight: its outcome is stamped by on_detach, each parked
    straggler is paired with one compensator release when its worker
    frees, and late results are discarded.

    `cv`, `detached` and `straggling` may be shared across dispatches
    (the writer fan-out detaches for the rest of the stream)."""

    def __init__(self, pool, compensator, cv=None,
                 detached=None, straggling=None):
        self.pool = pool
        self.comp = compensator
        self.cv = cv if cv is not None else threading.Condition()
        self.detached = detached if detached is not None else set()
        self.straggling = straggling if straggling is not None else set()

    def _release(self, i):
        if i in self.straggling:
            self.straggling.discard(i)
            self.comp.released()

    def dispatch(self, attempt, pending, inline, quorum,
                 deadline_s, grace_s, *, count_ok, record,
                 on_detach, skip=None, on_stragglers=None):
        cv = self.cv
        detached = self.detached

        def run(i):
            with cv:
                # Detached (or skippable) while still queued: never start
                # work whose result is already discarded.
                if i in detached or (skip is not None and skip(i)):
                    pending.discard(i)
                    self._release(i)
                    cv.notify_all()
                    return
            err = None
            try:
                attempt(i)
            except Exception as exc:  # noqa: BLE001 - collected for quorum
                # Kept without its traceback, whose frames (and the
                # buffers they hold) would sit in a reference cycle.
                err = exc.with_traceback(None)
            with cv:
                if i in detached:
                    # Finished after detach: discarded, and counted.
                    _note_late_drop(err)
                    self._release(i)
                    cv.notify_all()
                    return
                pending.discard(i)
                record(i, err)
                # Wake the waiter only where its decision can change:
                # every task done, quorum reached (its grace starts), or
                # quorum out of reach. Each wake-up costs a GIL hand-off,
                # and a block's other completions would only send it back
                # to sleep.
                ok = count_ok()
                if not pending or ok >= quorum or ok + len(pending) < quorum:
                    cv.notify_all()

        # Pool threads carry the caller's trace and op tag, so their disk
        # records and ledger bytes count under this request.
        bound = obs_carry(run)
        for i in sorted(pending):
            self.pool.submit(bound, i)
        for i in inline:
            run(i)

        quorum_wait(cv, pending, count_ok, quorum, deadline_s, grace_s)
        with cv:
            if pending and on_stragglers is not None:
                on_stragglers(len(pending))
            for i in list(pending):
                detached.add(i)
                self.straggling.add(i)
                self.comp.parked()
                on_detach(i)
                pending.discard(i)
                # The detach itself, a mark on the request's timeline.
                spans.record("fanout", f"straggler-detach #{i}", 0)

"""Pipeline executor, the counterpart of minio_tpu/pipeline/executor.py:
a chain of stages, one thread each, connected by bounded queues.

Semantics:
- Backpressure: every inter-stage queue is bounded (`queue_depth`); a
  slow stage stalls its upstream instead of buffering the stream.
- Ordering: one worker per stage and FIFO queues, so items leave the
  pipeline in source order (GET writes to a client, PUT writes shard
  chunks in sequence).
- First-error cancellation: the first raising stage wins; a cancel flag
  turns every queue wait into a prompt abort, workers exit, and
  run()/results() re-raise the original error after every thread has
  been joined. No worker outlives the call.
- Counters: per-stage items, bytes, busy, starved and stalled seconds,
  flushed once a run into pipeline.metrics.
- Spans: under a request trace, each stage execution records a `stage`
  span, and a queue wait of at least _SPAN_WAIT_MIN_NS a `stage-wait`
  (starved on its input) or `stage-stall` (blocked by its downstream)
  span, labelled "pipeline/stage". The stage threads carry the caller's
  trace and op tag.
"""

from __future__ import annotations

import queue as _queue
import threading
import time

from ..observability import carry as obs_carry
from ..observability import spans
from . import metrics as _pmetrics
from .stage import CANCELLED, END_OF_STREAM, SKIP, Stage, StageStats

# Poll interval of the cancel-aware queue waits: queue.Queue has no
# wait-with-abort, so blocked workers re-check the cancel flag at this
# cadence. A hand-off itself is immediate; the poll only bounds how long
# a cancelled pipeline keeps its threads.
_POLL_S = 0.05

# Queue waits shorter than this record no span: a hand-off that found
# its item ready is not worth a record in the ring.
_SPAN_WAIT_MIN_NS = 500_000  # 0.5 ms


class PipelineCancelled(Exception):
    """The pipeline was cancelled (externally or by the consumer) before
    the stream completed."""


class Pipeline:
    """A linear chain of stages run with stage overlap.

    name        -- label of the counters ("put", "get", ...).
    stages      -- list[Stage], run in order.
    queue_depth -- bound of every inter-stage queue.
    pools       -- BufferPools whose stats to flush with each run.
    drop        -- optional item -> None cleanup, called for every payload
                   item the pipeline abandons on error or cancellation
                   (stranded in a queue, or produced but never enqueued).
                   Drivers that thread pooled buffers through their items
                   return them here. An item is dropped at most once, and
                   never after the stage that releases it consumed it.
    """

    def __init__(self, name: str, stages: list[Stage],
                 queue_depth: int = 2, pools: list | None = None,
                 drop=None):
        if not stages:
            raise ValueError("pipeline needs at least one stage")
        self.name = name
        self.stages = stages
        self.queue_depth = max(1, queue_depth)
        self.pools = pools or []
        self._drop = drop
        self._cancel = threading.Event()
        self._err_mu = threading.Lock()
        self._error: BaseException | None = None

    def _drop_item(self, item) -> None:
        if self._drop is None or item is END_OF_STREAM or item is CANCELLED:
            return
        try:
            self._drop(item)
        except Exception:  # noqa: BLE001 - cleanup; the first error propagates
            pass

    # --- cancel-aware queue operations ---

    def _put(self, q: _queue.Queue, item) -> bool:
        while not self._cancel.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except _queue.Full:
                continue
        return False

    def _get(self, q: _queue.Queue):
        while not self._cancel.is_set():
            try:
                return q.get(timeout=_POLL_S)
            except _queue.Empty:
                continue
        return CANCELLED

    def _fail(self, exc: BaseException, stage: Stage | None = None) -> None:
        with self._err_mu:
            if self._error is None:
                self._error = exc
        if stage is not None:
            stage.stats.errors += 1
        self._cancel.set()

    def cancel(self) -> None:
        """External abort: workers drain promptly; run()/results() raise
        PipelineCancelled unless a stage error came first."""
        self._cancel.set()

    # --- workers ---

    def _feed(self, source, out_q: _queue.Queue) -> None:
        try:
            for item in source:
                if not self._put(out_q, item):
                    self._drop_item(item)
                    return
        except BaseException as exc:  # noqa: BLE001 - first error wins
            self._fail(exc)
            return
        self._put(out_q, END_OF_STREAM)

    def _work(self, stage: Stage, in_q: _queue.Queue,
              out_q: _queue.Queue) -> None:
        stats = stage.stats
        # One label a (pipeline, stage); no records outside a trace.
        span_label = f"{self.name}/{stage.name}"
        traced = spans.current() is not None
        while True:
            t0 = time.perf_counter()
            item = self._get(in_q)
            wait = time.perf_counter() - t0
            stats.wait_s += wait
            if item is CANCELLED:
                return
            if item is END_OF_STREAM:
                self._put(out_q, END_OF_STREAM)
                return
            if traced and wait * 1e9 >= _SPAN_WAIT_MIN_NS:
                # Starved: this stage waited on its upstream.
                spans.record("stage-wait", span_label, int(wait * 1e9))
            try:
                t0 = time.perf_counter()
                out = stage.fn(item)
                busy = time.perf_counter() - t0
                stats.busy_s += busy
                if traced:
                    spans.record("stage", span_label, int(busy * 1e9))
            except BaseException as exc:  # noqa: BLE001 - first error wins
                # A stage releases an item's pooled buffer only on full
                # success, so the failed item still carries it.
                self._drop_item(item)
                self._fail(exc, stage)
                return
            if out is SKIP:
                continue
            stats.items += 1
            if stage.bytes_of is not None:
                try:
                    stats.bytes += int(stage.bytes_of(out))
                except Exception:  # noqa: BLE001 - a counter never fails the stage
                    pass
            t0 = time.perf_counter()
            ok = self._put(out_q, out)
            stall = time.perf_counter() - t0
            stats.stall_s += stall
            if traced and stall * 1e9 >= _SPAN_WAIT_MIN_NS:
                # Backpressure: the downstream is the bottleneck.
                spans.record("stage-stall", span_label, int(stall * 1e9))
            if not ok:
                self._drop_item(out)
                return
            _pmetrics.record_queue_depth(self.name, stage.name,
                                         out_q.qsize())

    # --- driving ---

    def results(self, source):
        """Run the pipeline over `source`, yielding the last stage's
        outputs in order on the caller's thread. Joins every worker
        before returning or raising, also when the consumer abandons the
        generator mid-stream."""
        # Fresh per run: stats and the cancel/error state, so one
        # Pipeline may serve sequential runs.
        for st in self.stages:
            st.stats = StageStats()
        self._cancel = threading.Event()
        with self._err_mu:
            self._error = None
        queues = [_queue.Queue(maxsize=self.queue_depth)
                  for _ in range(len(self.stages) + 1)]
        # The stage threads carry the caller's trace and op tag, so the
        # disk ops the stages make count under the request being served.
        threads = [threading.Thread(
            target=obs_carry(self._feed), args=(source, queues[0]),
            name=f"mtpu-pipe-{self.name}-src", daemon=True)]
        for i, st in enumerate(self.stages):
            threads.append(threading.Thread(
                target=obs_carry(self._work),
                args=(st, queues[i], queues[i + 1]),
                name=f"mtpu-pipe-{self.name}-{st.name}", daemon=True))
        for t in threads:
            t.start()
        out_q = queues[-1]
        cancelled_mid = False
        try:
            while True:
                item = self._get(out_q)
                if item is CANCELLED:
                    cancelled_mid = True
                    break
                if item is END_OF_STREAM:
                    break
                yield item
        except GeneratorExit:
            # The consumer bailed (a client hung up): cancel so upstream
            # producers unblock, then join below.
            self._cancel.set()
            raise
        finally:
            self._cancel_wait_flush(threads, queues)
        if self._error is not None:
            raise self._error
        if cancelled_mid:
            raise PipelineCancelled(self.name)

    def run(self, source) -> int:
        """Drive to completion, discarding the last stage's outputs;
        returns how many it produced. Raises the first stage or source
        error."""
        n = 0
        for _ in self.results(source):
            n += 1
        return n

    def _cancel_wait_flush(self, threads, queues=()) -> None:
        # Everything upstream is done or cancelled: setting cancel lets
        # any straggler blocked on a full queue exit, so the join is
        # bounded.
        self._cancel.set()
        for t in threads:
            t.join()
        # Anything still queued never reached its releasing stage:
        # return those items' pooled buffers before the pool stats.
        if self._drop is not None:
            for q in queues:
                while True:
                    try:
                        self._drop_item(q.get_nowait())
                    except _queue.Empty:
                        break
        _pmetrics.record_run(self.name, self.stages,
                             error=self._error is not None)
        for p in self.pools:
            _pmetrics.record_pool(p)

    def stage_stats(self) -> dict:
        """The last run's per-stage stats."""
        return {st.name: st.stats.as_dict() for st in self.stages}

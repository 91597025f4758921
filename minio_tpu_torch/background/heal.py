"""Background heal services, the port's copy of minio_tpu/background/
heal.py: the MRF (most recently failed) drain loop and the erasure-set
sweep (MinIO's cmd/erasure-sets.go mrfOperations and cmd/global-heal.go
healErasureSet). Admin heal sequences are in healseq.py.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..observability import ioflow
from ..pipeline import Pipeline, Stage
from ..utils import fanout
from ..utils.errors import ErrObjectNotFound, ErrVersionNotFound
from . import healpace

# Drain-rate window: (monotonic time, healed) samples a drain pass.
_RATE_WINDOW_S = 300.0


class MRFHealer:
    """Drain the sets' MRF queues (writes that met quorum but missed some
    drives, reads that found a bad shard) and heal those objects (MinIO's
    mrfOpCh, cmd/erasure.go:75)."""

    def __init__(self, object_layer):
        self.ol = object_layer
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.healed_total = 0  # guarded-by: _rate_mu
        # Drain samples over the last _RATE_WINDOW_S: entries healed a
        # second.
        self._drained: deque = deque()  # guarded-by: _rate_mu
        self._rate_mu = threading.Lock()
        self._interval_s = 5.0  # the rate span's floor; start() sets it

    def drain_rate_per_s(self) -> float:
        now = time.monotonic()
        with self._rate_mu:
            while self._drained and now - self._drained[0][0] > _RATE_WINDOW_S:
                self._drained.popleft()
            if not self._drained:
                return 0.0
            # The span is floored at the drain interval: one fresh sample
            # read just after its pass is N an interval, not N over the
            # read's latency.
            span = max(self._interval_s, now - self._drained[0][0])
            return sum(n for _, n in self._drained) / span

    def _note_drained(self, healed: int) -> None:
        # drain_once runs from the healer's loop and from the disk
        # monitor's reconnect hook, so the total shares the window's lock.
        with self._rate_mu:
            self.healed_total += healed
            self._drained.append((time.monotonic(), healed))
            while self._drained and (self._drained[-1][0]
                                     - self._drained[0][0]) > _RATE_WINDOW_S:
                self._drained.popleft()

    def drain_once(self) -> int:
        """Heal every queued entry once; returns the entries healed. A
        key queued twice is healed once, with its first time. While the
        disk monitor has pulled a drive of a set, that set's entries are
        held, not healed: a heal then skips the drive, and the drive's
        reconnect drain heals them onto it. (minio_tpu heals and drops
        them, so a write during an outage longer than one drain interval
        never reaches the returning drive, and its heal may take the
        pulled drives' shards for missing ones.)"""
        healed = 0
        for pool in getattr(self.ol, "pools", []):
            for es in pool.sets:
                first: dict = {}
                for bucket, object_, version_id, t0 in \
                        es.drain_mrf(with_times=True):
                    key = (bucket, object_, version_id)
                    first[key] = min(t0, first.get(key, t0))
                if any(d is None for d in es.disks):
                    for key, t0 in first.items():
                        es.queue_mrf(*key, enqueued_at=t0)
                    continue
                for (bucket, object_, version_id), t0 in first.items():
                    try:
                        # remove_dangling: an entry may be a delete that a
                        # drive missed; its leftover copy is sub-quorum
                        # garbage to purge, not a quorum failure to
                        # requeue for ever.
                        es.heal_object(bucket, object_, version_id,
                                       remove_dangling=True)
                    except (ErrObjectNotFound, ErrVersionNotFound):
                        # Nothing left to heal on any reachable drive:
                        # requeueing would spin for ever.
                        continue
                    except Exception:  # noqa: BLE001 - requeued
                        # With its first time: a repair that keeps
                        # failing keeps aging in mrf_stats.
                        es.queue_mrf(bucket, object_, version_id,
                                     enqueued_at=t0)
                        continue
                    healed += 1
        self._note_drained(healed)
        return healed

    def start(self, interval_s: float = 5.0) -> "MRFHealer":
        self._interval_s = max(1e-3, interval_s)

        def loop():
            while not self._stop.wait(self._pace_delay(interval_s)):
                self.drain_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="mtpu-mrf")
        self._thread.start()
        return self

    @staticmethod
    def _pace_delay(interval_s: float) -> float:
        """Stretch the drain interval while the heal pacer reports
        foreground pressure: skipping the next pass is cheaper than one
        that spends its time yielding. At most 4x, so the backlog keeps
        draining."""
        p = healpace.installed()
        if p is None or not p.cfg.enabled:
            return interval_s
        try:
            if p.pressured():
                return min(4.0 * interval_s, interval_s + 2.0)
        except Exception:  # noqa: BLE001 - pacing never stops the drain
            pass
        return interval_s

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


def heal_erasure_set(object_layer, buckets: list[str] | None = None) -> dict:
    """Heal every object of `buckets` (default: every user bucket), the
    fresh-drive sweep of cmd/global-heal.go:154 healErasureSet. The
    listing walk feeds a bounded queue that the heal stage drains, so
    listing the next page overlaps healing the last; one core heals
    serially (utils.fanout.SINGLE_CORE). A heal that fails is counted,
    never fatal. Returns {"buckets", "objects", "failed"}."""
    result = {"buckets": 0, "objects": 0, "failed": 0}
    names = buckets
    if names is None:
        names = [b.name for b in object_layer.list_buckets()
                 if not b.name.startswith(".")]

    def listing():
        for bucket in names:
            result["buckets"] += 1
            marker = ""
            while True:
                res = object_layer.list_objects(bucket, marker=marker,
                                                max_keys=1000)
                for oi in res.objects:
                    yield (bucket, oi.name)
                if not res.is_truncated:
                    break
                marker = res.next_marker

    def heal_one(item):
        bucket, name = item
        try:
            object_layer.heal_object(bucket, name)
            result["objects"] += 1
        except Exception:  # noqa: BLE001 - counted
            result["failed"] += 1
        return item

    # The sweep's listing I/O is heal work too.
    with ioflow.tag("heal"):
        if fanout.SINGLE_CORE:
            for item in listing():
                heal_one(item)
        else:
            Pipeline("heal-sweep", [Stage("heal", heal_one)],
                     queue_depth=64).run(listing())
    return result

"""The data scanner, the port's copy of minio_tpu/background/scanner.py:
a continuous namespace crawl that keeps the data-usage snapshot and
heals a sample of the objects it visits, under an adaptive throttle
(MinIO's cmd/data-scanner.go: runDataScanner :90, healObjectSelectProb
:52, dynamicSleeper :1160; cmd/data-usage-cache.go).

Left out: lifecycle (ILM) expiry and transition, noncurrent-version and
delete-marker expiry, and the abort of stale multipart uploads. The port
has no lifecycle engine (`bucket/lifecycle.py`, `tier.py`) and stores no
lifecycle configuration, so no bucket of the port has rules; a drive set
that minio_tpu wrote with rules is scanned here without them.
"""

from __future__ import annotations

import io
import json
import threading
import time
from dataclasses import dataclass, field

from ..observability import ioflow
from ..utils.errors import (
    ErrBucketNotFound,
    ErrObjectNotFound,
    ErrVersionNotFound,
    StorageError,
)

# 1 in N objects visited gets a heal check (healObjectSelectProb).
HEAL_OBJECT_SELECT_PROB = 512

# Per-bucket histograms in fixed log2 bins: O(1) memory a bucket.
SIZE_HIST_BINS = 40    # 2^0 .. 2^39; bin 0 also holds size 0
VERSION_HIST_BINS = 16  # up to 2^15 versions an object


def _log2_bin(v: int, bins: int) -> int:
    if v <= 0:
        return 0
    return min(v.bit_length() - 1, bins - 1)


@dataclass
class BucketUsage:
    objects_count: int = 0
    objects_size: int = 0
    versions_count: int = 0
    size_hist: list[int] = field(
        default_factory=lambda: [0] * SIZE_HIST_BINS)
    versions_hist: list[int] = field(
        default_factory=lambda: [0] * VERSION_HIST_BINS)

    def observe(self, size: int, versions: int) -> None:
        self.size_hist[_log2_bin(size, SIZE_HIST_BINS)] += 1
        self.versions_hist[_log2_bin(versions, VERSION_HIST_BINS)] += 1


@dataclass
class DataUsageInfo:
    """The namespace's usage (MinIO's DataUsageInfo)."""

    last_update_ns: int = 0
    objects_total_count: int = 0
    objects_total_size: int = 0
    buckets_count: int = 0
    buckets_usage: dict[str, BucketUsage] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "lastUpdateNs": self.last_update_ns,
            "objectsTotalCount": self.objects_total_count,
            "objectsTotalSize": self.objects_total_size,
            "bucketsCount": self.buckets_count,
            "bucketsUsage": {b: vars(u)
                             for b, u in self.buckets_usage.items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DataUsageInfo":
        out = cls(last_update_ns=d.get("lastUpdateNs", 0),
                  objects_total_count=d.get("objectsTotalCount", 0),
                  objects_total_size=d.get("objectsTotalSize", 0),
                  buckets_count=d.get("bucketsCount", 0))
        for b, u in d.get("bucketsUsage", {}).items():
            bu = BucketUsage(objects_count=u.get("objects_count", 0),
                             objects_size=u.get("objects_size", 0),
                             versions_count=u.get("versions_count", 0))
            # Snapshots from before the histograms load with empty ones.
            for name, bins in (("size_hist", SIZE_HIST_BINS),
                               ("versions_hist", VERSION_HIST_BINS)):
                hist = u.get(name)
                if isinstance(hist, list) and len(hist) == bins:
                    setattr(bu, name, list(hist))
            out.buckets_usage[b] = bu
        return out


class DynamicSleeper:
    """An adaptive throttle: sleep `factor` times the work's time, so the
    scan yields to foreground I/O (cmd/data-scanner.go:1160-1290)."""

    def __init__(self, factor: float = 10.0, max_sleep_s: float = 1.0):
        self.factor = factor
        self.max_sleep_s = max_sleep_s

    def timer(self):
        t0 = time.perf_counter()

        def done():
            work = time.perf_counter() - t0
            time.sleep(min(work * self.factor, self.max_sleep_s))

        return done


class DataScanner:
    """Scan cycles over every bucket and object: keeps the DataUsageInfo
    and heals a sampled subset. `tracker` (a DataUpdateTracker) lets a
    cycle skip the buckets no write touched since the last."""

    USAGE_PATH = "scanner/data-usage.json"
    META_BUCKET = ".minio.sys"

    # A full pass every this many cycles covers the skipped buckets, so
    # heal sampling never starves (dataUsageUpdateDirCycles).
    FULL_SCAN_CYCLES = 16

    def __init__(self, object_layer, heal_prob: int = HEAL_OBJECT_SELECT_PROB,
                 sleeper: DynamicSleeper | None = None, tracker=None):
        self.ol = object_layer
        self.heal_prob = max(1, heal_prob)
        self.sleeper = sleeper or DynamicSleeper()
        self.usage = DataUsageInfo()
        self.tracker = tracker
        self.cycles_completed = 0
        self.buckets_skipped_last_cycle = 0
        self._counter = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # A cycle's progress, and the objects visited ever.
        self.objects_scanned_total = 0
        self.cycle_started_ns = 0
        self._cycle_ended_ns = 0
        self.cycle_buckets_total = 0
        self.cycle_buckets_done = 0
        self.last_cycle_duration_s = 0.0
        self._cycle_objects_seen = 0

    def load_usage(self) -> None:
        """Restore the saved snapshot, so a restarted node serves it."""
        try:
            raw = self.ol.get_object_bytes(self.META_BUCKET, self.USAGE_PATH)
            self.usage = DataUsageInfo.from_dict(json.loads(raw))
        except (StorageError, ValueError):
            return

    def save_usage(self) -> None:
        raw = json.dumps(self.usage.to_dict()).encode()
        try:
            self.ol.put_object(self.META_BUCKET, self.USAGE_PATH,
                               io.BytesIO(raw), len(raw))
        except ErrBucketNotFound:
            self.ol.make_bucket(self.META_BUCKET)
            self.ol.put_object(self.META_BUCKET, self.USAGE_PATH,
                               io.BytesIO(raw), len(raw))

    def scan_cycle(self) -> DataUsageInfo:
        full_pass = (self.tracker is None
                     or self.cycles_completed % self.FULL_SCAN_CYCLES == 0)
        if self.tracker is not None:
            self.tracker.advance()
        try:
            # A sampled heal retags itself at the heal choke point.
            with ioflow.tag("scan"):
                return self._scan_cycle(full_pass)
        except BaseException:
            # A failed cycle must not swallow the change marks it took.
            if self.tracker is not None:
                self.tracker.restore()
            raise

    def _scan_cycle(self, full_pass: bool) -> DataUsageInfo:
        usage = DataUsageInfo()
        self.buckets_skipped_last_cycle = 0
        buckets = [b for b in self.ol.list_buckets()
                   if not b.name.startswith(".")]
        self.cycle_started_ns = time.monotonic_ns()
        self._cycle_ended_ns = 0
        self.cycle_buckets_total = len(buckets)
        self.cycle_buckets_done = 0
        cycle_objects = 0
        self._cycle_objects_seen = cycle_objects
        for b in buckets:
            # An unchanged bucket keeps its last usage with no work per
            # object, except on the periodic full pass.
            if (not full_pass
                    and b.name in self.usage.buckets_usage
                    and not self.tracker.changed_since_last_cycle(b.name)):
                bu_prev = self.usage.buckets_usage[b.name]
                usage.buckets_usage[b.name] = bu_prev
                usage.objects_total_count += bu_prev.objects_count
                usage.objects_total_size += bu_prev.objects_size
                self.buckets_skipped_last_cycle += 1
                self.cycle_buckets_done += 1
                continue
            bu = BucketUsage()
            marker = ""
            while True:
                res = self.ol.list_objects(b.name, marker=marker,
                                           max_keys=1000)
                done = self.sleeper.timer()
                for oi in res.objects:
                    self._counter += 1
                    self.objects_scanned_total += 1
                    cycle_objects += 1
                    bu.objects_count += 1
                    bu.objects_size += oi.size
                    bu.versions_count += max(1, oi.num_versions)
                    bu.observe(oi.size, max(1, oi.num_versions))
                    if self._counter % self.heal_prob == 0:
                        self._heal_one(b.name, oi.name)
                done()
                self._cycle_objects_seen = cycle_objects
                if not res.is_truncated:
                    break
                marker = res.next_marker
            usage.buckets_usage[b.name] = bu
            usage.objects_total_count += bu.objects_count
            usage.objects_total_size += bu.objects_size
            self.cycle_buckets_done += 1
        usage.buckets_count = len(usage.buckets_usage)
        usage.last_update_ns = time.time_ns()
        self.usage = usage
        self._cycle_ended_ns = time.monotonic_ns()
        self.last_cycle_duration_s = (
            (self._cycle_ended_ns - self.cycle_started_ns) / 1e9)
        self.save_usage()
        if self.tracker is not None:
            self.tracker.save()
        self.cycles_completed += 1
        return usage

    def progress(self) -> dict:
        """The cycle's progress: buckets covered, visit rate and a bucket-
        rate ETA (the admin usage endpoint)."""
        total = self.cycle_buckets_total
        done = self.cycle_buckets_done
        frac = (done / total) if total else 0.0
        # Between cycles the clock stops at the last cycle's end.
        if not self.cycle_started_ns:
            elapsed = 0.0
        else:
            end = (self._cycle_ended_ns
                   if self._cycle_ended_ns >= self.cycle_started_ns
                   else time.monotonic_ns())
            elapsed = (end - self.cycle_started_ns) / 1e9
        ops = self._cycle_objects_seen / elapsed if elapsed > 0 else 0.0
        eta = (elapsed * (total - done) / done) if done and total else 0.0
        return {
            "cycle": self.cycles_completed,
            "bucketsTotal": total,
            "bucketsDone": done,
            "progress": round(frac, 4),
            "objectsPerSecond": round(ops, 2),
            "etaSeconds": round(eta, 2),
            "elapsedSeconds": round(elapsed, 2),
            "objectsScannedTotal": self.objects_scanned_total,
            "lastCycleDurationSeconds": round(self.last_cycle_duration_s, 3),
        }

    def _heal_one(self, bucket: str, object_: str) -> None:
        try:
            self.ol.heal_object(bucket, object_)
        except (ErrObjectNotFound, ErrVersionNotFound):
            pass  # gone between the listing and the heal
        except Exception:  # noqa: BLE001 - the sample is best effort
            pass

    def start(self, interval_s: float = 60.0) -> "DataScanner":
        self.load_usage()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.scan_cycle()
                except Exception:  # noqa: BLE001 - keep scanning
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="mtpu-scanner")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

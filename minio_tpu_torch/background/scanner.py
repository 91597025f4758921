"""The data scanner, the port's copy of minio_tpu/background/scanner.py:
a continuous namespace crawl that keeps the data-usage snapshot, heals a
sample of the objects it visits and applies the buckets' lifecycle
rules, under an adaptive throttle (MinIO's cmd/data-scanner.go:
runDataScanner :90, healObjectSelectProb :52, applyActions :937,
dynamicSleeper :1160; cmd/data-usage-cache.go).

Lifecycle (bucket/lifecycle.py): a current version past its Expiration
is expired as an S3 DELETE without a version id would do it in its
bucket, a delete marker where versioning is enabled (minio_tpu deletes
with no options there, which finds no version and expires nothing);
noncurrent versions past NoncurrentDays beyond the newest
NewerNoncurrentVersions are deleted, except a version under retention or
legal hold, which MinIO keeps (evalActionFromLifecycle) and minio_tpu
deletes; a delete marker left alone goes with ExpiredObjectDeleteMarker;
and AbortIncompleteMultipartUpload aborts the bucket's stale uploads.
Every deletion adds one to `ilm_expired_total`.

Tiers (tier.py, with the server's TierEngine): a current version that
did not expire and whose Transition is due moves to the rule's tier
(`ilm_transitioned_total`), and a transitioned version whose restored
copy is past its expiry at the cycle's `now` drops back to metadata only
(minio_tpu reads the wall clock there). A transition or expiry that
fails is logged and tried again the next cycle; a write that raced the
upload, or the listing an expiry was decided on, aborts it.
"""

from __future__ import annotations

import io
import json
import threading
import time
from dataclasses import dataclass, field

from .. import tier
from ..bucket import objectlock
from ..bucket.lifecycle import Lifecycle, LifecycleError
from ..object.types import ObjectOptions
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


def parse_lifecycle(xml_text: str) -> Lifecycle:
    """A bucket's stored rules, read leniently: a rule that fails to
    parse is dropped alone, and a document that does not parse gives no
    rules, so the scanner keeps cycling (the write path validates)."""
    try:
        return Lifecycle.parse(xml_text, best_effort=True)
    except LifecycleError:
        return Lifecycle([])


class DataScanner:
    """Scan cycles over every bucket and object: keeps the DataUsageInfo,
    heals a sampled subset and applies the lifecycle rules that
    `bucket_meta` (a BucketMetadataSys; None: no rules) stores.
    `tracker` (a DataUpdateTracker) lets a cycle skip the buckets no
    write touched since the last. `metrics` receives the scanner_* and
    ilm_expired_total series, `logger` the errors of a cycle.
    `tier_engine` (a tier.TierEngine; None: no Transition applies)
    transitions and expires restored copies."""

    USAGE_PATH = "scanner/data-usage.json"
    META_BUCKET = ".minio.sys"

    # A full pass every this many cycles covers the skipped buckets, so
    # heal sampling never starves (dataUsageUpdateDirCycles).
    FULL_SCAN_CYCLES = 16

    def __init__(self, object_layer, bucket_meta=None,
                 heal_prob: int = HEAL_OBJECT_SELECT_PROB,
                 sleeper: DynamicSleeper | None = None, metrics=None,
                 logger=None, tracker=None, tier_engine=None):
        self.ol = object_layer
        self.bm = bucket_meta
        self.heal_prob = max(1, heal_prob)
        self.sleeper = sleeper or DynamicSleeper()
        self.metrics = metrics
        self.logger = logger
        self.tier_engine = tier_engine
        self.usage = DataUsageInfo()
        self.tracker = tracker
        self.cycles_completed = 0
        self.buckets_skipped_last_cycle = 0
        self._counter = 0
        # The multipart tree, walked at most once a cycle.
        self._cycle_uploads = None
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
        now_ns = time.time_ns()
        self.buckets_skipped_last_cycle = 0
        self._cycle_uploads = None
        buckets = [b for b in self.ol.list_buckets()
                   if not b.name.startswith(".")]
        self.cycle_started_ns = time.monotonic_ns()
        self._cycle_ended_ns = 0
        self.cycle_buckets_total = len(buckets)
        self.cycle_buckets_done = 0
        cycle_objects = 0
        self._publish_progress(cycle_objects)
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
                if self.metrics is not None:
                    self.metrics.inc("scanner_buckets_skipped_total")
                continue
            rules = parse_lifecycle(self.bm.get(b.name).lifecycle_xml
                                    if self.bm is not None else "")
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
                    if self._apply_lifecycle(b.name, oi, rules, now_ns):
                        continue
                    bu.objects_count += 1
                    bu.objects_size += oi.size
                    bu.versions_count += max(1, oi.num_versions)
                    bu.observe(oi.size, max(1, oi.num_versions))
                    if self._counter % self.heal_prob == 0:
                        self._heal_one(b.name, oi.name)
                done()
                self._publish_progress(cycle_objects)
                if not res.is_truncated:
                    break
                marker = res.next_marker
            # Version-level ILM (noncurrent expiry, orphan delete markers)
            # and the abort of stale uploads run only where a rule asks.
            if rules.any_noncurrent_or_marker_rules():
                self._versions_sweep(b.name, rules, now_ns)
            if rules.any_abort_mpu_rules():
                self._abort_stale_uploads(b.name, rules, now_ns)
            usage.buckets_usage[b.name] = bu
            usage.objects_total_count += bu.objects_count
            usage.objects_total_size += bu.objects_size
            self.cycle_buckets_done += 1
            self._publish_progress(cycle_objects)
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
        self._publish_progress(cycle_objects)
        if self.metrics is not None:
            self.metrics.inc("scanner_cycles_total")
            self.metrics.set_gauge("scanner_objects_total",
                                   usage.objects_total_count)
            self.metrics.set_gauge("scanner_cycle_duration_seconds",
                                   round(self.last_cycle_duration_s, 3))
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

    def _publish_progress(self, cycle_objects: int) -> None:
        self._cycle_objects_seen = cycle_objects
        if self.metrics is None:
            return
        p = self.progress()
        self.metrics.set_gauge("scanner_cycle_progress", p["progress"])
        self.metrics.set_gauge("scanner_objects_per_second",
                               p["objectsPerSecond"])
        self.metrics.set_gauge("scanner_cycle_eta_seconds", p["etaSeconds"])

    def _log(self, exc: Exception, context: str) -> None:
        if self.logger is not None:
            self.logger.log_once_if(exc, context)

    def _expired(self) -> None:
        if self.metrics is not None:
            self.metrics.inc("ilm_expired_total")

    def _apply_lifecycle(self, bucket: str, oi, rules, now_ns: int) -> bool:
        """Expire the current version `oi` if a rule says so, as an
        untargeted DELETE does in its bucket: a delete marker where
        versioning is enabled, else the (null) version removed. One that
        stays moves to its tier when a Transition is due, and a restored
        copy past its expiry goes. True when it expired."""
        now_s = now_ns / 1e9
        if rules.expire_current(oi.name, oi.user_defined, oi.mod_time_ns,
                                now_s):
            bmeta = self.bm.get(bucket)
            try:
                self.ol.delete_object(bucket, oi.name, ObjectOptions(
                    versioned=bmeta.versioning_enabled,
                    version_suspended=bmeta.versioning_suspended))
            except StorageError as exc:
                self._log(exc, f"ilm:{bucket}")
            else:
                self._expired()
                return True
        if self.tier_engine is None:
            return False
        if tier.is_transitioned(oi.user_defined):
            try:
                self.tier_engine.expire_restored(
                    bucket, oi.name, oi.user_defined, now_s,
                    mod_time_ns=oi.mod_time_ns)
            except (StorageError, OSError) as exc:
                self._log(exc, f"tier-expire:{bucket}")
            return False
        tier_name = rules.transition_tier_due(oi.name, oi.user_defined,
                                              oi.mod_time_ns, now_s)
        if tier_name:
            try:
                self.tier_engine.transition(bucket, oi.name, tier_name)
            except (StorageError, OSError) as exc:
                self._log(exc, f"tier:{bucket}")
        return False

    def _versions_sweep(self, bucket: str, rules, now_ns: int) -> None:
        """Version-level lifecycle (applyVersionActions): delete the
        noncurrent versions past NoncurrentDays beyond the newest
        NewerNoncurrentVersions, unless retained or held, and a latest
        delete marker whose key has no other version
        (ExpiredObjectDeleteMarker).

        A version's noncurrent age runs from its successor's mod time,
        when it became noncurrent, never from its own. A page may split a
        key's versions, so the successor's time and the noncurrent rank
        carry across pages, and an orphan marker is confirmed by a
        listing of its key before it goes."""
        key_marker = vid_marker = ""
        carry_key, carry_mtime, carry_rank = "", None, 0
        while True:
            res = self.ol.list_object_versions(
                bucket, key_marker=key_marker,
                version_id_marker=vid_marker, max_keys=1000)
            by_key: dict[str, list] = {}
            for v in res.versions:
                by_key.setdefault(v.name, []).append(v)
            # The resume markers must name a surviving version: a deleted
            # one no longer resolves in the next page's listing.
            survivor_key, survivor_vid = key_marker, vid_marker
            deleted_last = False
            rank_by_key: dict[str, int] = {}
            for key, versions in by_key.items():
                noncur_limit, keep_newer = rules.noncurrent_policy(key)
                wants_marker = rules.wants_delete_marker_cleanup(key)
                if noncur_limit is None and not wants_marker:
                    continue
                # Newest first: versions[i]'s successor is versions[i-1],
                # or the previous page's last when the key was split.
                prev_mtime = carry_mtime if key == carry_key else None
                rank = carry_rank if key == carry_key else 0
                for v in versions:
                    expired = False
                    if not v.is_latest and prev_mtime is not None:
                        rank += 1  # 1 is the newest noncurrent version
                        noncur_days = (now_ns - prev_mtime) / 1e9 / 86400
                        if (noncur_limit is not None
                                and noncur_days >= noncur_limit
                                and rank > keep_newer
                                and not self._retained(v)):
                            self._delete_version(bucket, key, v.version_id)
                            expired = True
                    prev_mtime = v.mod_time_ns
                    if expired:
                        deleted_last = v is res.versions[-1]
                    else:
                        survivor_key, survivor_vid = key, v.version_id
                        if v is res.versions[-1]:
                            deleted_last = False
                rank_by_key[key] = rank
                if (len(versions) == 1 and versions[0].is_latest
                        and versions[0].delete_marker and wants_marker):
                    # An orphan on this page: a page boundary can hide the
                    # key's older versions, so list the key first.
                    check = self.ol.list_object_versions(bucket, prefix=key,
                                                         max_keys=10)
                    mine = [x for x in check.versions if x.name == key]
                    if (len(mine) == 1 and mine[0].delete_marker
                            and mine[0].version_id
                            == versions[0].version_id):
                        self._delete_version(bucket, key,
                                             versions[0].version_id)
            if res.versions:
                last = res.versions[-1]
                carry_key, carry_mtime = last.name, last.mod_time_ns
                carry_rank = rank_by_key.get(last.name, 0)
            if not res.is_truncated:
                return
            if deleted_last:
                # The page ended on a deleted version: resume from the last
                # survivor (some work may repeat; nothing is skipped).
                key_marker, vid_marker = survivor_key, survivor_vid
            else:
                key_marker = res.next_key_marker
                vid_marker = res.next_version_id_marker

    @staticmethod
    def _retained(v) -> bool:
        """A version under retention or legal hold stays past its
        noncurrent expiry (enforceRetentionForDeletion, with no
        governance bypass)."""
        return (not v.delete_marker and objectlock.check_deletable(
            v.user_defined, bypass_governance=False) is not None)

    def _delete_version(self, bucket: str, key: str, version_id: str) -> None:
        try:
            self.ol.delete_object(bucket, key,
                                  ObjectOptions(version_id=version_id))
        except StorageError as exc:
            self._log(exc, f"ilm-version:{bucket}")
            return
        self._expired()

    def _abort_stale_uploads(self, bucket: str, rules, now_ns: int) -> None:
        """AbortIncompleteMultipartUpload: each upload of the bucket is
        judged by the rules whose prefix matches its object, so a short
        rule for one prefix never aborts uploads only a longer one
        covers. The multipart tree is walked once a cycle."""
        if self._cycle_uploads is None:
            self._cycle_uploads = [
                (es, rec) for pool in self.ol.pools for es in pool.sets
                for rec in es.list_multipart_uploads_all()]
        for es, ((b, o, upload_id), started_ns) in self._cycle_uploads:
            if b != bucket:
                continue
            days = rules.abort_mpu_after_days(o)
            if days is None or now_ns - started_ns < days * 86400 * 10 ** 9:
                continue
            try:
                es.abort_multipart_upload(b, o, upload_id)
            except Exception as exc:  # noqa: BLE001 - retried next cycle
                self._log(exc, f"ilm-mpu:{bucket}")

    def _heal_one(self, bucket: str, object_: str) -> None:
        try:
            res = self.ol.heal_object(bucket, object_)
        except (ErrObjectNotFound, ErrVersionNotFound):
            return  # gone between the listing and the heal
        except Exception as exc:  # noqa: BLE001 - the sample is best effort
            if self.metrics is not None:
                self.metrics.inc("heal_failures_total")
            self._log(exc, f"scan-heal:{bucket}")
            return
        if self.metrics is not None:
            self.metrics.inc("scanner_heal_checks_total")
            # Pools answer a list when the object is in more than one.
            results = res if isinstance(res, list) else [res]
            if any(r.get("healed") for r in results):
                self.metrics.inc("heal_objects_total", trigger="scanner")

    def start(self, interval_s: float = 60.0) -> "DataScanner":
        self.load_usage()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.scan_cycle()
                except Exception as exc:  # noqa: BLE001 - keep scanning
                    self._log(exc, "scanner-cycle")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="mtpu-scanner")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

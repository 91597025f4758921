"""Metrics v2, the port's copy of minio_tpu/observability/metrics_v2.py:
the typed descriptor catalog and the scrape-time collector behind
/minio/v2/metrics/{cluster,node} and /minio/prometheus/metrics (MinIO's
descriptors of cmd/metrics-v2.go).

Two kinds of series:
- event-driven counters and histograms, recorded where they happen (the
  S3 dispatch, disk ops through MetricsDisk, the admission governors,
  pipeline runs, spans, the codec registry);
- snapshot gauges that `MetricsCollector.collect()` fills at each scrape
  from the live subsystems: disks, usage, IAM, the MRF scoreboard, the
  byte-flow ledger, the heal pacer and the node.

The catalog is minio_tpu's less the lists of four subsystems the port
does not have yet, each named where it would join: the mesh plane
(MESH_DESCRIPTORS), the worker pool (WORKER_DESCRIPTORS), the RPC plane
(RPC_DESCRIPTORS) and the read tier (READTIER_DESCRIPTORS). Their series
never appear here, nor do the collectors of replication and the disk
cache.
"""

from __future__ import annotations

import os
import threading
import time

# Descriptor catalog: (name, type, help). Mirrors the reference families
# (cmd/metrics-v2.go getNodeMetrics/getClusterMetrics descriptor lists);
# names keep the mtpu_ namespace prefix applied by the registry.
DESCRIPTORS: list[tuple[str, str, str]] = [
    # --- S3 API plane ---
    ("s3_requests_total", "counter", "Total S3 requests by API"),
    ("s3_responses_total", "counter", "S3 responses by API and status"),
    ("s3_errors_total", "counter", "S3 error responses by API and code"),
    ("s3_request_seconds", "histogram", "S3 request latency by API"),
    ("s3_requests_inflight", "gauge", "S3 requests currently in flight"),
    ("s3_rx_bytes_total", "counter", "Bytes received in S3 request bodies"),
    ("s3_tx_bytes_total", "counter", "Bytes sent in S3 response bodies"),
    ("s3_auth_failures_total", "counter", "Rejected signatures/policies"),
    ("s3_requests_rejected_total", "counter",
     "S3 requests rejected by the api requests_max throttle"),
    # --- per-disk storage ---
    ("disk_ops_total", "counter", "Storage ops by op and disk"),
    ("disk_op_errors_total", "counter", "Failed storage ops by op/disk"),
    ("disk_op_seconds", "histogram", "Storage op latency by op"),
    ("disk_total_bytes", "gauge", "Disk capacity by disk"),
    ("disk_free_bytes", "gauge", "Disk free space by disk"),
    ("disk_used_bytes", "gauge", "Disk used space by disk"),
    ("disk_online", "gauge", "1 when the disk is online"),
    ("disks_offline_count", "gauge", "Offline disks in the deployment"),
    ("disk_offline_total", "counter", "Disk offline transitions"),
    ("disk_reconnect_total", "counter", "Disk reconnect events"),
    # --- in-band disk health (circuit breaker / deadlines) ---
    ("disk_health_state", "gauge",
     "0 when healthy, 1 when latched faulty by the circuit breaker"),
    ("disk_inflight", "gauge", "In-flight storage ops per disk"),
    ("disk_op_timeouts_total", "counter",
     "Storage ops abandoned at their wall-clock deadline"),
    ("disk_inflight_rejected_total", "counter",
     "Storage ops rejected because the per-disk token budget was full"),
    ("disk_faulty_total", "counter",
     "Circuit-breaker latch events (disk marked faulty)"),
    ("disk_readmit_total", "counter",
     "Faulty disks re-admitted by the background probe"),
    ("disk_fresh_healed_total", "counter",
     "Replaced disks healed back to full shard sets"),
    ("hedged_reads_total", "counter",
     "GET shard reads hedged onto parity past the hedge delay"),
    ("fanout_stragglers_total", "counter",
     "Erasure fan-out writers detached after write quorum"),
    ("fanout_late_dropped_errors_total", "counter",
     "Detached-straggler failures discarded after the grace window"),
    ("fanout_late_dropped_results_total", "counter",
     "Detached-straggler successes discarded after the grace window"),
    ("dsync_unlock_failures_total", "counter",
     "dsync unlock RPCs that failed (grant leaks until expiry)"),
    # --- erasure/heal + the heal/MRF scoreboard ---
    ("heal_objects_total", "counter", "Objects healed by trigger"),
    ("heal_failures_total", "counter", "Object heal failures"),
    ("mrf_healed_total", "counter", "MRF queue entries healed"),
    ("mrf_pending", "gauge", "MRF entries awaiting heal"),
    ("mrf_oldest_age_seconds", "gauge",
     "Age of the oldest entry in any MRF queue"),
    ("mrf_drain_rate", "gauge",
     "MRF entries healed per second (5-minute window)"),
    ("erasure_set_online_disks", "gauge",
     "Online disks per erasure set (pool/set labels)"),
    ("erasure_set_health", "gauge",
     "1 when the erasure set holds read quorum, 0 when not"),
    ("erasure_set_mrf_pending", "gauge",
     "MRF backlog depth per erasure set"),
    # --- scanner / ILM / usage ---
    ("scanner_cycles_total", "counter", "Completed scanner cycles"),
    ("scanner_objects_total", "counter", "Objects visited by the scanner"),
    ("scanner_heal_checks_total", "counter", "Scanner deep heal checks"),
    ("scanner_buckets_skipped_total", "counter",
     "Buckets skipped via the update tracker"),
    ("scanner_cycle_progress", "gauge",
     "Fraction of buckets covered by the running scan cycle (0-1)"),
    ("scanner_objects_per_second", "gauge",
     "Objects visited per second by the running scan cycle"),
    ("scanner_cycle_eta_seconds", "gauge",
     "Naive bucket-rate ETA for the running scan cycle"),
    ("scanner_cycle_duration_seconds", "gauge",
     "Wall time of the last completed scan cycle"),
    ("bucket_objects_size_distribution", "gauge",
     "Per-bucket object-size histogram (log2 bins, bin label = 2^i)"),
    ("bucket_objects_version_distribution", "gauge",
     "Per-bucket versions-per-object histogram (log2 bins)"),
    ("ilm_expired_total", "counter", "Objects expired by lifecycle"),
    ("ilm_transitioned_total", "counter", "Objects tiered by lifecycle"),
    ("ilm_restored_total", "counter", "Objects restored from tiers"),
    ("usage_last_activity_ns", "gauge", "Scanner usage snapshot age"),
    ("bucket_usage_total_bytes", "gauge", "Bucket logical size"),
    ("bucket_usage_object_count", "gauge", "Bucket object count"),
    ("usage_total_bytes", "gauge", "Deployment logical size"),
    ("usage_object_total", "gauge", "Deployment object count"),
    ("usage_bucket_total", "gauge", "Number of buckets"),
    # --- replication / bandwidth ---
    ("replication_queued_total", "counter", "Replication tasks queued"),
    ("replication_completed_total", "counter", "Replication successes"),
    ("replication_failed_total", "counter", "Replication failures"),
    ("replication_retried_total", "counter", "Replication retries"),
    ("replication_pending", "gauge", "Replication tasks in queue"),
    ("replication_bandwidth_bytes_total", "counter",
     "Bytes shipped to replication targets"),
    ("replication_bandwidth_limit_bytes", "gauge",
     "Configured byte/s limit per bucket/target"),
    ("replication_bandwidth_current_bytes", "gauge",
     "Current byte/s per bucket/target"),
    # --- events / notifications ---
    ("events_sent_total", "counter", "Notification events delivered"),
    ("events_errors_total", "counter", "Notification delivery errors"),
    ("events_dropped_total", "counter", "Notification events dropped"),
    # --- disk cache ---
    ("cache_hits_total", "counter", "Disk cache hits"),
    ("cache_misses_total", "counter", "Disk cache misses"),
    ("cache_usage_bytes", "gauge", "Disk cache bytes used"),
    ("cache_quota_bytes", "gauge", "Disk cache quota"),
    # --- IAM / STS ---
    ("iam_users", "gauge", "IAM users"),
    ("iam_policies", "gauge", "Canned policies"),
    ("iam_sts_credentials", "gauge", "Live STS credentials"),
    # --- node / process ---
    ("node_uptime_seconds", "gauge", "Process uptime"),
    ("node_threads", "gauge", "Live threads (goroutine analog)"),
    ("node_rss_bytes", "gauge", "Resident set size"),
    ("node_open_fds", "gauge", "Open file descriptors"),
    ("node_cpu_seconds_total", "gauge", "Process CPU time"),
    # --- observability plane ---
    ("pubsub_dropped_total", "counter",
     "Items dropped for slow pub/sub subscribers, by bus"),
]

# Request spans (observability/spans.py): per-kind latency histograms
# and slow-request capture counts.
from .spans import SPAN_DESCRIPTORS  # noqa: E402

DESCRIPTORS += SPAN_DESCRIPTORS

# The byte-flow ledger (observability/ioflow.py): per-drive, per-op-class
# bytes, the repair-efficiency series and the hot-bucket sketch.
from .ioflow import IOFLOW_DESCRIPTORS  # noqa: E402

DESCRIPTORS += IOFLOW_DESCRIPTORS

# Per-stage pipeline counters (pipeline/metrics.py), flushed once a run.
from ..pipeline.metrics import PIPELINE_DESCRIPTORS  # noqa: E402

DESCRIPTORS += PIPELINE_DESCRIPTORS

# minio_tpu's MESH_DESCRIPTORS (parallel/metrics.py) join here: the mesh
# plane is not ported (ROADMAP Queue 1 item 11).

# The admission governors (pipeline/admission.py).
from ..pipeline.admission import ADMISSION_DESCRIPTORS  # noqa: E402

DESCRIPTORS += ADMISSION_DESCRIPTORS

# minio_tpu's WORKER_DESCRIPTORS (pipeline/workers.py, the encode worker
# pool) and RPC_DESCRIPTORS (distributed/rest.py, the node-to-node RPC
# plane) join here: neither subsystem is ported (ROADMAP Queue 1 item 10).

# The codec registry (erasure/registry.py): selections, dispatches and
# probe throughputs.
from ..erasure.registry import CODEC_DESCRIPTORS  # noqa: E402

DESCRIPTORS += CODEC_DESCRIPTORS

# The heal pacer (background/healpace.py).
from ..background.healpace import HEALPACE_DESCRIPTORS  # noqa: E402

DESCRIPTORS += HEALPACE_DESCRIPTORS

# minio_tpu's READTIER_DESCRIPTORS (object/readtier.py, the hot-object
# tier) join here: the read tier is not ported (ROADMAP Queue 1 item 10).


def mrf_scoreboard(ol) -> dict:
    """One traversal of the heal/MRF scoreboard, consumed by
    BOTH the Prometheus collector (_collect_mrf) and the admin
    /v3/ioflow payload — a single source so the two surfaces cannot
    drift. Returns {"pending", "oldest_age_s", "sets": [{pool, set,
    pending, oldest_age_s, online, disks, healthy}]}."""
    out: dict = {"pending": 0, "oldest_age_s": 0.0, "sets": []}
    for pool in getattr(ol, "pools", []):
        for pi, es in enumerate(getattr(pool, "sets", [])):
            stats_fn = getattr(es, "mrf_stats", None)
            if stats_fn is not None:
                st = stats_fn()
            else:
                st = {"pending": len(getattr(es, "_mrf", ())),
                      "oldest_age_s": 0.0}
            out["pending"] += st["pending"]
            oldest = st.get("oldest_age_s", 0.0)
            out["oldest_age_s"] = max(out["oldest_age_s"], oldest)
            disks = getattr(es, "disks", [])
            online = 0
            for d in disks:
                try:
                    online += 1 if d is not None and d.is_online() else 0
                except Exception:  # noqa: BLE001 - counts offline
                    pass
            # READ quorum = data blocks (k): a set that cannot serve
            # GETs must not report healthy, and majority (n//2)
            # overstates health for low-parity layouts.
            parity = getattr(es, "default_parity", None)
            quorum = (len(disks) - parity if parity is not None
                      else len(disks) // 2) if disks else 0
            out["sets"].append({
                "pool": getattr(es, "pool_index", 0),
                "set": getattr(es, "set_index", pi),
                "pending": st["pending"],
                "oldest_age_s": oldest,
                "online": online,
                "disks": len(disks),
                "healthy": bool(disks) and online >= quorum,
            })
    return out


def describe_all(metrics) -> None:
    for name, _type, help_text in DESCRIPTORS:
        metrics.describe(name, help_text)


class MetricsCollector:
    """Populates snapshot gauges from live subsystems at scrape time.
    Attach the pieces that exist; everything is optional."""

    def __init__(self, metrics, object_layer=None, scanner=None,
                 iam=None, mrf=None):
        self.metrics = metrics
        self.ol = object_layer
        self.scanner = scanner
        self.iam = iam
        self.mrf = mrf
        self.started = time.time()
        self._disk_scan_at = 0.0
        describe_all(metrics)

    def collect(self):
        m = self.metrics
        self._collect_disks(m)
        self._collect_usage(m)
        self._collect_iam(m)
        self._collect_mrf(m)
        self._collect_ioflow(m)
        self._collect_healpace(m)
        self._collect_node(m)

    # Disk stats are bounded to one walk a window, so a hung drive can
    # stall at most one scrape in each (MinIO serves disk metrics from
    # the monitor's cached probe state).
    DISK_SCAN_INTERVAL_S = 10.0

    def _collect_disks(self, m):
        if self.ol is None:
            return
        now = time.monotonic()
        if now - self._disk_scan_at < self.DISK_SCAN_INTERVAL_S:
            return  # previous gauges stay in the registry
        self._disk_scan_at = now
        offline = 0
        for pool in getattr(self.ol, "pools", []):
            for d in pool.disks:
                if d is None:
                    offline += 1
                    continue
                ep = d.endpoint()
                hi = getattr(d, "health_info", None)
                hi = hi() if callable(hi) else None
                if hi is not None:
                    # Breaker/token state from the in-band tracker — no
                    # RPC, just counters (ref the cached health state the
                    # reference serves from xl-storage-disk-id-check).
                    m.set_gauge("disk_health_state",
                                1.0 if hi["state"] == "faulty" else 0.0,
                                disk=ep)
                    m.set_gauge("disk_inflight", hi["inflight"], disk=ep)
                try:
                    online = d.is_online()
                except Exception:  # noqa: BLE001
                    online = False
                m.set_gauge("disk_online", 1.0 if online else 0.0, disk=ep)
                if not online:
                    offline += 1
                    continue
                try:
                    di = d.disk_info()
                except Exception:  # noqa: BLE001
                    continue
                m.set_gauge("disk_total_bytes", di.total, disk=ep)
                m.set_gauge("disk_free_bytes", di.free, disk=ep)
                m.set_gauge("disk_used_bytes", di.used, disk=ep)
        m.set_gauge("disks_offline_count", offline)

    def _collect_usage(self, m):
        if self.scanner is None:
            return
        usage = getattr(self.scanner, "usage", None)
        if usage is None or not usage.last_update_ns:
            return
        m.set_gauge("usage_last_activity_ns",
                    time.time_ns() - usage.last_update_ns)
        m.set_gauge("usage_total_bytes", usage.objects_total_size)
        m.set_gauge("usage_object_total", usage.objects_total_count)
        m.set_gauge("usage_bucket_total", len(usage.buckets_usage))
        # Streaming log2 histograms: only occupied bins
        # export, so series cardinality tracks real data shape — and
        # whole-series replace drops bins that EMPTIED (or buckets that
        # were deleted) since the last cycle rather than freezing them.
        size_series: list = []
        ver_series: list = []
        bytes_series: list = []
        count_series: list = []
        for bucket, bu in usage.buckets_usage.items():
            bytes_series.append(({"bucket": bucket}, bu.objects_size))
            count_series.append(({"bucket": bucket}, bu.objects_count))
            for i, n in enumerate(getattr(bu, "size_hist", ())):
                if n:
                    size_series.append(
                        ({"bucket": bucket, "bin": f"2^{i}"}, n))
            for i, n in enumerate(getattr(bu, "versions_hist", ())):
                if n:
                    ver_series.append(
                        ({"bucket": bucket, "bin": f"2^{i}"}, n))
        m.replace_gauge_series("bucket_usage_total_bytes", bytes_series)
        m.replace_gauge_series("bucket_usage_object_count", count_series)
        m.replace_gauge_series("bucket_objects_size_distribution",
                               size_series)
        m.replace_gauge_series("bucket_objects_version_distribution",
                               ver_series)

    def _collect_iam(self, m):
        if self.iam is None:
            return
        try:
            m.set_gauge("iam_users", len(self.iam.users))
            m.set_gauge("iam_policies", len(self.iam.policies))
            m.set_gauge("iam_sts_credentials", len(self.iam.sts))
        except Exception:  # noqa: BLE001
            pass

    def _collect_mrf(self, m):
        """Heal/MRF scoreboard: backlog depth, age of the oldest queued
        entry, drain rate, per-erasure-set health."""
        if self.ol is None:
            return
        sb = mrf_scoreboard(self.ol)
        for s in sb["sets"]:
            labels = {"pool": str(s["pool"]), "set": str(s["set"])}
            m.set_gauge("erasure_set_online_disks", s["online"], **labels)
            m.set_gauge("erasure_set_health",
                        1.0 if s["healthy"] else 0.0, **labels)
            m.set_gauge("erasure_set_mrf_pending", s["pending"], **labels)
        m.set_gauge("mrf_pending", sb["pending"])
        m.set_gauge("mrf_oldest_age_seconds", round(sb["oldest_age_s"], 3))
        if self.mrf is not None and hasattr(self.mrf, "drain_rate_per_s"):
            m.set_gauge("mrf_drain_rate",
                        round(self.mrf.drain_rate_per_s(), 4))

    def _collect_ioflow(self, m):
        """Byte-flow ledger mirror: absolute per-(drive, op, dir)
        totals + derived efficiency series + the hot-bucket sketch."""
        from . import ioflow

        snap = ioflow.snapshot()
        for (drive, op, dir_), n in snap["bytes"].items():
            m.set_counter("ioflow_bytes_total", n,
                          drive=drive, op=op, dir=dir_)
        for op, n in snap["logical"].items():
            m.set_counter("ioflow_logical_bytes_total", n, op=op)
        scanned = getattr(self.scanner, "objects_scanned_total", 0) \
            if self.scanner is not None else 0
        eff = ioflow.efficiency(snap, scan_objects=scanned)
        for name, v in eff.items():
            if v is not None:
                m.set_gauge(name, v)
        # Whole-series replace: a bucket evicted from the top-K sketch
        # drops out of the exposition instead of freezing at its last
        # value (keeps label cardinality at the sketch's O(K) bound).
        m.replace_counter_series(
            "hot_bucket_bytes_total",
            [({"bucket": e["bucket"]}, e["bytes"])
             for e in ioflow.hot_buckets()],
        )
        for kind, n in snap["served"].items():
            m.set_counter("ioflow_served_bytes_total", n, kind=kind)

    def _collect_healpace(self, m):
        """Heal pacer mirror. installed() never constructs: deployments
        without heal traffic keep a clean exposition."""
        from ..background import healpace

        p = healpace.installed()
        if p is None:
            return
        snap = p.snapshot()
        m.set_gauge("heal_pace_tokens", snap["tokens"])
        m.set_gauge("heal_pace_inflight", snap["inflight"])
        m.set_gauge("heal_pace_disk_p99_seconds",
                    snap["disk_p99_ms"] / 1000.0)
        m.set_counter("heal_pace_grants_total", snap["grants_total"])
        m.set_counter("heal_pace_deadline_grants_total",
                      snap["deadline_grants_total"])
        m.set_counter("heal_pace_yields_total", snap["yields_total"])
        m.set_counter("heal_pace_throttle_seconds_total",
                      snap["throttle_seconds_total"])

    def _collect_node(self, m):
        m.set_gauge("node_uptime_seconds", time.time() - self.started)
        m.set_gauge("node_threads", threading.active_count())
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        m.set_gauge("node_rss_bytes",
                                    int(line.split()[1]) * 1024)
                        break
        except OSError:
            pass
        try:
            m.set_gauge("node_open_fds", len(os.listdir("/proc/self/fd")))
        except OSError:
            pass
        try:
            t = os.times()
            m.set_gauge("node_cpu_seconds_total", t.user + t.system)
        except OSError:
            pass

"""The admin routes of the port, its copy of AdminHandlers of
minio_tpu/api/admin.py: heal (MinIO's /minio/admin/v3/heal,
cmd/admin-heal-ops.go), datausage (a listing walk), usage (the data
scanner's snapshot), kms (KMSKeyStatusHandler and KES CreateKey over
the server's LocalKMS), ioflow (the byte-flow ledger with the heal/MRF
scoreboard), metrics (the Prometheus exposition, also behind the scrape
routes) and slow-requests (the span plane's exemplar store, GET and
DELETE). The rest of the admin API is not ported: its routes answer
NotImplemented.
"""

from __future__ import annotations

import json
import time

from ..background.healseq import (
    AllHealState,
    HealAlreadyRunning,
    HealNoSuchSequence,
    HealOverlap,
    make_io_gate,
)
from ..crypto.kms import KMSError
from ..iam.policy import Args
from .errors import S3Error
from .handlers import Response

ADMIN_PREFIX = "/minio/admin/v3"

# minio_tpu's heal settings with no heal configuration: a sequence waits
# (up to 1 s an object) while HEAL_MAX_IO requests are in flight, and
# pauses after each object it heals (max_sleep 1 s, of which a sequence
# takes 1/100).
HEAL_MAX_IO = 10
HEAL_MAX_SLEEP_S = 0.01


# The ported routes, and the IAM action of each, as minio_tpu names them.
_ROUTES = {("GET", "datausage"): "data_usage_info",
           ("GET", "usage"): "usage_info",
           ("GET", "ioflow"): "ioflow_report",
           ("GET", "metrics"): "metrics_snapshot",
           ("POST", "heal"): "heal",
           ("GET", "slow-requests"): "slow_requests",
           ("DELETE", "slow-requests"): "slow_requests_clear",
           ("GET", "kms"): "kms_status",
           ("POST", "kms"): "kms_create_key"}
ACTIONS = {"data_usage_info": "admin:DataUsageInfo",
           "usage_info": "admin:DataUsageInfo",
           "ioflow_report": "admin:ServerInfo",
           "metrics_snapshot": "admin:Prometheus",
           "heal": "admin:Heal",
           "slow_requests": "admin:ServerTrace",
           "slow_requests_clear": "admin:ServerTrace",
           "kms_status": "admin:KMSKeyStatus",
           "kms_create_key": "admin:KMSCreateKey"}


class AdminHandlers:
    """`inflight` returns the S3 requests in flight, which a heal
    sequence yields to. `scanner` is the server's DataScanner, which the
    usage route serves (None: 503). `kms` is the server's LocalKMS
    (None: the kms routes answer NotImplemented). `metrics` is the
    server's registry and `collector` its MetricsCollector (the server
    attaches it), which the metrics and ioflow routes read."""

    def __init__(self, object_layer, iam, inflight, kms=None, metrics=None):
        self.ol = object_layer
        self.iam = iam
        self.inflight = inflight
        self.kms = kms
        self.metrics = metrics
        self.heal_state = AllHealState()
        self.scanner = None
        self.collector = None

    def route(self, ctx) -> str:
        rest = ctx.path[len(ADMIN_PREFIX):].strip("/")
        name = _ROUTES.get((ctx.method, rest.split("/", 1)[0]))
        if name is None:
            raise S3Error("NotImplemented", f"admin {ctx.method} /{rest}")
        return name

    def authorize(self, auth_result, name: str) -> None:
        if auth_result.is_anonymous:
            raise S3Error("AccessDenied", "admin API requires signature")
        action = ACTIONS[name]
        if not self.iam.is_allowed(Args(account=auth_result.access_key,
                                        action=action)):
            raise S3Error("AccessDenied",
                          f"{auth_result.access_key} {action}")

    @staticmethod
    def _json(obj, status: int = 200) -> Response:
        return Response(status, {"Content-Type": "application/json"},
                        json.dumps(obj).encode())

    def data_usage_info(self, ctx) -> Response:
        """GET /minio/admin/v3/datausage: each user bucket's object count
        and bytes, by a listing walk."""
        usage = {"bucketsUsage": {}, "objectsTotalCount": 0,
                 "objectsTotalSize": 0}
        for b in self.ol.list_buckets():
            if b.name.startswith("."):
                continue
            count = size = 0
            marker = ""
            while True:
                res = self.ol.list_objects(b.name, marker=marker,
                                           max_keys=1000)
                for oi in res.objects:
                    count += 1
                    size += oi.size
                if not res.is_truncated:
                    break
                marker = res.next_marker
            usage["bucketsUsage"][b.name] = {"objectsCount": count,
                                             "size": size}
            usage["objectsTotalCount"] += count
            usage["objectsTotalSize"] += size
        usage["lastUpdate"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                            time.gmtime())
        return self._json(usage)

    def usage_info(self, ctx) -> Response:
        """GET /minio/admin/v3/usage[?histogram=true]: the scanner's
        usage snapshot (no walk), with its cycle's progress and, with
        histogram=true, each bucket's log2 size and version-count
        histograms."""
        scanner = self.scanner
        if scanner is None:
            return self._json({"error": "scanner not running"}, status=503)
        usage = scanner.usage
        want_hist = ctx.qdict.get("histogram", "") in ("true", "1")
        buckets = {}
        for b, bu in usage.buckets_usage.items():
            entry = {"objectsCount": bu.objects_count,
                     "objectsSize": bu.objects_size,
                     "versionsCount": bu.versions_count}
            if want_hist:
                entry["sizeHistogram"] = {
                    f"2^{i}": n for i, n in enumerate(bu.size_hist) if n}
                entry["versionsHistogram"] = {
                    f"2^{i}": n for i, n in enumerate(bu.versions_hist) if n}
            buckets[b] = entry
        return self._json({
            "lastUpdateNs": usage.last_update_ns,
            "objectsTotalCount": usage.objects_total_count,
            "objectsTotalSize": usage.objects_total_size,
            "bucketsCount": usage.buckets_count,
            "bucketsUsage": buckets,
            "scanner": scanner.progress(),
        })

    def ioflow_report(self, ctx) -> Response:
        """GET /minio/admin/v3/ioflow: the byte-flow ledger (bytes by op
        class, drive and direction, the derived efficiency series, the
        hot buckets) and the heal/MRF scoreboard."""
        from ..observability import ioflow
        from ..observability.metrics_v2 import mrf_scoreboard

        scanner = getattr(self.collector, "scanner", None)
        scanned = getattr(scanner, "objects_scanned_total", 0) \
            if scanner is not None else 0
        out = ioflow.report(scan_objects=scanned)
        mrf = getattr(self.collector, "mrf", None)
        # The collector's own traversal, so the JSON and the exposition
        # cannot drift; every key is there, zeroed without an MRF healer.
        sb = mrf_scoreboard(self.ol)
        scoreboard: dict = {
            "pending": sb["pending"],
            "oldestAgeSeconds": sb["oldest_age_s"],
            "drainRatePerSecond": 0.0, "healedTotal": 0,
            "sets": [{
                "pool": s["pool"], "set": s["set"],
                "pending": s["pending"],
                "oldestAgeSeconds": s["oldest_age_s"],
                "onlineDisks": s["online"], "disks": s["disks"],
                "healthy": s["healthy"],
            } for s in sb["sets"]],
        }
        if mrf is not None and hasattr(mrf, "drain_rate_per_s"):
            scoreboard["drainRatePerSecond"] = round(
                mrf.drain_rate_per_s(), 4)
            scoreboard["healedTotal"] = getattr(mrf, "healed_total", 0)
        out["healScoreboard"] = scoreboard
        return self._json(out)

    def metrics_snapshot(self, ctx) -> Response:
        """The Prometheus text exposition, its snapshot gauges filled by
        the collector first (MinIO computes them in the handler)."""
        if self.metrics is None:
            return Response(200, {"Content-Type": "text/plain"}, b"")
        if self.collector is not None:
            self.collector.collect()
        return Response(
            200, {"Content-Type": "text/plain; version=0.0.4"},
            self.metrics.render_prometheus().encode())

    def slow_requests(self, ctx) -> Response:
        """GET /minio/admin/v3/slow-requests[?n=]: the span trees of the
        requests that crossed the capture threshold (MTPU_TRACE_SLOW_MS,
        or the running p99), newest last."""
        from ..observability import spans

        try:
            n = int(ctx.qdict.get("n", str(spans.SLOW_STORE_CAP)))
        except ValueError:
            n = spans.SLOW_STORE_CAP
        threshold = spans.slow_threshold_ms()
        return self._json({
            "threshold_ms": None if threshold == float("inf") else threshold,
            "captured": spans.slow_requests(max(1, n)),
        })

    def slow_requests_clear(self, ctx) -> Response:
        from ..observability import spans

        return self._json({"cleared": spans.clear_slow_requests()})

    def heal(self, ctx) -> Response:
        """POST /minio/admin/v3/heal/<bucket>/<prefix>:

        - no clientToken: start a sequence and return its token at once;
        - clientToken=<t>: poll its status, taking the buffered items;
        - forceStop=true: stop every sequence under the path;
        - forceStart=true: replace a running sequence on the path.
        With no bucket it rewrites format.json on every disk."""
        rest = ctx.path[len(ADMIN_PREFIX) + len("/heal"):].strip("/")
        bucket, _, prefix = rest.partition("/")
        if not bucket:
            return self._json({"healSequence": "format",
                               "result": self.ol.heal_format()})
        if ctx.qdict.get("forceStop", "") == "true":
            return self._json({"stopped": self.heal_state.stop(bucket,
                                                                prefix)})
        token = ctx.qdict.get("clientToken", "")
        if token:
            try:
                return self._json(self.heal_state.status(bucket, prefix,
                                                         token))
            except HealNoSuchSequence:
                raise S3Error(
                    "InvalidArgument",
                    f"no heal sequence for {bucket}/{prefix} "
                    f"with that token") from None
        # A bucket that does not exist is a 404 now, not a sequence that
        # fails where no one looks.
        try:
            self.ol.get_bucket_info(bucket)
        except Exception as exc:  # noqa: BLE001 - any failure is a 404
            raise S3Error("NoSuchBucket", f"{bucket}: {exc}") from exc
        try:
            seq = self.heal_state.launch(
                self.ol, bucket, prefix,
                force_start=ctx.qdict.get("forceStart", "") == "true",
                remove_dangling=ctx.qdict.get("remove", "") == "true",
                dry_run=ctx.qdict.get("dryRun", "") == "true",
                io_gate=make_io_gate(self.inflight, HEAL_MAX_IO),
                max_sleep_s=HEAL_MAX_SLEEP_S,
            )
        except (HealAlreadyRunning, HealOverlap) as exc:
            raise S3Error("InvalidArgument", str(exc)) from exc
        return self._json({"clientToken": seq.token, "clientAddress": "",
                           "startTime": seq.start_time})

    # --- KMS (KMSKeyStatusHandler, cmd/admin-handlers.go, and KES
    # CreateKey; the server's LocalKMS serves both) ---

    def kms_status(self, ctx) -> Response:
        """GET /minio/admin/v3/kms/key/status[?key-id=]: a round trip of
        each key (or one); /kms/key/list: the key names."""
        if self.kms is None:
            raise S3Error("NotImplemented", "KMS not configured")
        if ctx.path.rstrip("/").endswith("/key/list"):
            return self._json({"keys": self.kms.list_keys()})
        key_id = ctx.qdict.get("key-id", "")
        status = self.kms.status()
        if key_id:
            keys = [k for k in status["keys"] if k["keyName"] == key_id]
            if not keys:
                raise S3Error("NoSuchKey", f"kms key {key_id}")
            status["keys"] = keys
        return self._json(status)

    def kms_create_key(self, ctx) -> Response:
        """POST /minio/admin/v3/kms/key/create?key-id=<name>."""
        if self.kms is None:
            raise S3Error("NotImplemented", "KMS not configured")
        key_id = ctx.qdict.get("key-id", "")
        if not key_id:
            raise S3Error("InvalidArgument", "key-id required")
        try:
            self.kms.create_key(key_id)
        except KMSError as exc:
            raise S3Error("InvalidArgument", str(exc)) from exc
        return self._json({"created": key_id})

"""The admin routes of the port, its copy of AdminHandlers of
minio_tpu/api/admin.py: heal (MinIO's /minio/admin/v3/heal,
cmd/admin-heal-ops.go), datausage (a listing walk), usage (the data
scanner's snapshot), kms (KMSKeyStatusHandler and KES CreateKey over
the server's LocalKMS), ioflow (the byte-flow ledger with the heal/MRF
scoreboard), metrics (the Prometheus exposition, also behind the scrape
routes), slow-requests (the span plane's exemplar store, GET and
DELETE), the six config routes (cmd/admin-handlers-config-kv.go:
get, set, del and help of a subsystem's KV set, the history list with
its sealed entries opened, and restore), the bucket quota's set and
get (cmd/admin-bucket-handlers.go), the remote tiers' add, list and
remove (madmin's tier registry; a list never shows a secret key, and a
tier that a bucket's lifecycle names is not removed), the users (list,
add, remove, enable or disable; cmd/admin-handlers-users.go; add-user
takes the secret in a clear JSON body, as minio_tpu does, where madmin
seals it), the canned policies (list, add, remove), a user's or group's
policy mapping, and the account info. The heal reads
the `heal` subsystem: its I/O gate waits while more than `max_io`
requests are in flight, and it pauses a hundredth of `max_sleep` after
each object. The rest of the admin API is not ported: its routes answer
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
from ..bucket.lifecycle import Lifecycle
from ..config import HELP
from ..crypto.kms import KMSError
from ..iam.policy import Args, Policy
from ..tier import META_TIER
from ..utils import parse_duration_s
from ..utils.errors import StorageError
from .errors import S3Error
from .handlers import Response

ADMIN_PREFIX = "/minio/admin/v3"


# The ported routes, and the IAM action of each, as minio_tpu names them.
_ROUTES = {("GET", "datausage"): "data_usage_info",
           ("GET", "usage"): "usage_info",
           ("GET", "ioflow"): "ioflow_report",
           ("GET", "metrics"): "metrics_snapshot",
           ("POST", "heal"): "heal",
           ("GET", "slow-requests"): "slow_requests",
           ("DELETE", "slow-requests"): "slow_requests_clear",
           ("GET", "kms"): "kms_status",
           ("POST", "kms"): "kms_create_key",
           ("GET", "get-config-kv"): "get_config_kv",
           ("PUT", "set-config-kv"): "set_config_kv",
           ("DELETE", "del-config-kv"): "del_config_kv",
           ("GET", "help-config-kv"): "help_config_kv",
           ("GET", "list-config-history-kv"): "list_config_history",
           ("PUT", "restore-config-history-kv"): "restore_config_history",
           ("PUT", "set-bucket-quota"): "set_bucket_quota",
           ("GET", "get-bucket-quota"): "get_bucket_quota",
           ("PUT", "add-tier"): "add_tier",
           ("GET", "list-tiers"): "list_tiers",
           ("DELETE", "remove-tier"): "remove_tier",
           ("GET", "list-users"): "list_users",
           ("PUT", "add-user"): "add_user",
           ("DELETE", "remove-user"): "remove_user",
           ("PUT", "set-user-status"): "set_user_status",
           ("GET", "list-canned-policies"): "list_policies",
           ("PUT", "add-canned-policy"): "add_policy",
           ("DELETE", "remove-canned-policy"): "remove_policy",
           ("PUT", "set-user-or-group-policy"): "set_policy_mapping",
           ("GET", "accountinfo"): "account_info"}
ACTIONS = {"data_usage_info": "admin:DataUsageInfo",
           "usage_info": "admin:DataUsageInfo",
           "ioflow_report": "admin:ServerInfo",
           "metrics_snapshot": "admin:Prometheus",
           "heal": "admin:Heal",
           "slow_requests": "admin:ServerTrace",
           "slow_requests_clear": "admin:ServerTrace",
           "kms_status": "admin:KMSKeyStatus",
           "kms_create_key": "admin:KMSCreateKey",
           "get_config_kv": "admin:ConfigUpdate",
           "set_config_kv": "admin:ConfigUpdate",
           "del_config_kv": "admin:ConfigUpdate",
           "help_config_kv": "admin:ConfigUpdate",
           "list_config_history": "admin:ConfigUpdate",
           "restore_config_history": "admin:ConfigUpdate",
           "set_bucket_quota": "admin:SetBucketQuota",
           "get_bucket_quota": "admin:GetBucketQuota",
           "add_tier": "admin:SetTier",
           "list_tiers": "admin:ListTier",
           "remove_tier": "admin:SetTier",
           "list_users": "admin:ListUsers",
           "add_user": "admin:CreateUser",
           "remove_user": "admin:DeleteUser",
           "set_user_status": "admin:EnableUser",
           "list_policies": "admin:ListUserPolicies",
           "add_policy": "admin:CreatePolicy",
           "remove_policy": "admin:DeletePolicy",
           "set_policy_mapping": "admin:AttachUserOrGroupPolicy",
           "account_info": "admin:AccountInfo"}
# api keys read once, when the S3 server is built: a set of one of them
# answers {"restart": true}.
_RESTART_KEYS = {"requests_max", "requests_deadline"}


class AdminHandlers:
    """`inflight` returns the S3 requests in flight, which a heal
    sequence yields to. `scanner` is the server's DataScanner, which the
    usage route serves (None: 503). `kms` is the server's LocalKMS
    (None: the kms routes answer NotImplemented). `metrics` is the
    server's registry and `collector` its MetricsCollector (the server
    attaches it), which the metrics and ioflow routes read. `config_sys`
    is the server's ConfigSys (None: the config routes answer
    NotImplemented, the heal takes the subsystem's defaults).
    `bucket_meta` is the server's BucketMetadataSys, where the quota
    routes keep a bucket's quota (None: they answer NotImplemented).
    `tiers` is the server's tier.TierConfigMgr (None: the tier routes
    answer NotImplemented)."""

    def __init__(self, object_layer, iam, inflight, kms=None, metrics=None,
                 config_sys=None, bucket_meta=None, tiers=None):
        self.ol = object_layer
        self.iam = iam
        self.inflight = inflight
        self.kms = kms
        self.metrics = metrics
        self.config_sys = config_sys
        self.bm = bucket_meta
        self.tiers = tiers
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
                io_gate=make_io_gate(self.inflight, self._heal_max_io()),
                max_sleep_s=self._heal_max_sleep_s(),
            )
        except (HealAlreadyRunning, HealOverlap) as exc:
            raise S3Error("InvalidArgument", str(exc)) from exc
        return self._json({"clientToken": seq.token, "clientAddress": "",
                           "startTime": seq.start_time})

    def _heal_config(self) -> dict:
        if self.config_sys is None:
            return {}
        try:
            return dict(self.config_sys.config.get("heal"))
        except ValueError:
            return {}

    def _heal_max_io(self) -> int:
        """The requests in flight above which a sequence waits."""
        try:
            return int(self._heal_config().get("max_io", "10") or "10")
        except ValueError:
            return 10

    def _heal_max_sleep_s(self) -> float:
        """The pause after each healed object: a hundredth of max_sleep
        (1 s by default), so that a bucket of a thousand objects does not
        take a thousand seconds."""
        secs = parse_duration_s(self._heal_config().get("max_sleep", "1s"),
                                default=1.0)
        return secs / 100

    # --- config KV (cmd/admin-handlers-config-kv.go) ---

    def _config_sys(self):
        if self.config_sys is None:
            raise S3Error("NotImplemented", "config system not wired")
        return self.config_sys

    def get_config_kv(self, ctx) -> Response:
        config_sys = self._config_sys()
        key = ctx.qdict.get("key", "")
        if not key:
            raise S3Error("InvalidArgument", "key required")
        try:
            kvs = config_sys.config.get(key)
        except ValueError as exc:
            raise S3Error("InvalidArgument", str(exc)) from exc
        return self._json({key: dict(kvs)})

    def set_config_kv(self, ctx) -> Response:
        """Body "subsys[:target] k=v k2=v2" (mc admin config set)."""
        config_sys = self._config_sys()
        try:
            parts = ctx.body.decode().split()
            target = parts[0]
            kv = dict(p.split("=", 1) for p in parts[1:])
            config_sys.config.set_kv(target, **kv)
        except (ValueError, IndexError) as exc:
            raise S3Error("InvalidArgument", str(exc)) from exc
        config_sys.save()
        return self._json({"restart": target.split(":", 1)[0] == "api"
                           and bool(_RESTART_KEYS & set(kv))})

    def del_config_kv(self, ctx) -> Response:
        config_sys = self._config_sys()
        target = ctx.body.decode().strip()
        if not target:
            raise S3Error("InvalidArgument", "config target required")
        try:
            config_sys.config.del_target(target)
        except (KeyError, ValueError) as exc:
            raise S3Error("InvalidArgument", str(exc)) from exc
        config_sys.save()
        return self._json({})

    def help_config_kv(self, ctx) -> Response:
        return self._json(HELP)

    def list_config_history(self, ctx) -> Response:
        """History entries newest first, with their opened KV sets when
        with-data=true."""
        config_sys = self._config_sys()
        names = sorted(config_sys.history(), reverse=True)
        try:
            count = int(ctx.qdict.get("count", "10"))
        except ValueError:
            count = 10
        out = []
        for name in names[:max(1, min(count, 100))]:
            entry = {"restoreId": name}
            if ctx.qdict.get("with-data") == "true":
                try:
                    entry["kv"] = json.loads(config_sys.history_get(name))
                except Exception:  # noqa: BLE001 - an unreadable entry
                    entry["error"] = "unreadable"
            out.append(entry)
        return self._json(out)

    def restore_config_history(self, ctx) -> Response:
        config_sys = self._config_sys()
        restore_id = ctx.qdict.get("restoreId", "")
        if not restore_id:
            raise S3Error("InvalidArgument", "restoreId required")
        try:
            config_sys.restore(restore_id)
        except ValueError as exc:
            raise S3Error("InvalidArgument", str(exc)) from exc
        except StorageError as exc:
            raise S3Error("NoSuchKey", f"config history: {exc}") from exc
        return self._json({"restored": restore_id})

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

    # ---------- bucket quota (PutBucketQuotaConfigHandler,
    # GetBucketQuotaConfigHandler) ----------

    def _quota_bucket(self, ctx) -> str:
        if self.bm is None:
            raise S3Error("NotImplemented", "no bucket metadata sys")
        bucket = ctx.qdict.get("bucket", "")
        if not bucket:
            raise S3Error("InvalidArgument", "bucket required")
        return bucket

    def set_bucket_quota(self, ctx) -> Response:
        """PUT set-bucket-quota?bucket=: madmin's {"quota": bytes,
        "quotatype": "hard" | "fifo"}, stored; an empty body clears it."""
        bucket = self._quota_bucket(ctx)
        if ctx.body:
            try:
                cfg = json.loads(ctx.body)
                quota = int(cfg.get("quota") or 0)
                qtype = (cfg.get("quotatype") or "hard").lower()
            except (ValueError, TypeError, AttributeError) as exc:
                raise S3Error("InvalidArgument", f"bad quota: {exc}") from exc
            if quota < 0 or qtype not in ("hard", "fifo"):
                raise S3Error("InvalidArgument", "bad quota config")
            raw = json.dumps({"quota": quota, "quotatype": qtype})
        else:
            raw = ""
        self.bm.update(bucket, "quota_json", raw)
        return self._json({"status": "ok"})

    def get_bucket_quota(self, ctx) -> Response:
        raw = getattr(self.bm.get(self._quota_bucket(ctx)), "quota_json",
                      "") or ""
        if not raw:
            return self._json({})
        return Response(200, {"Content-Type": "application/json"},
                        raw.encode())

    # ---------- remote tiers (madmin's tier registry, behind the
    # lifecycle's transitions) ----------

    def _tier_user(self, tier_name: str) -> str | None:
        """What names the tier: a bucket's lifecycle rule or a version
        transitioned to it; None when nothing does."""
        for b in self.ol.list_buckets():
            if self.bm is not None:
                lc = Lifecycle.parse(self.bm.get(b.name).lifecycle_xml or "",
                                     best_effort=True)
                if any(r.transition_tier.upper() == tier_name
                       for r in lc.rules):
                    return f"bucket {b.name!r} lifecycle configuration"
            marker = vid_marker = ""
            while True:
                page = self.ol.list_object_versions(
                    b.name, key_marker=marker, version_id_marker=vid_marker)
                for v in page.versions:
                    if v.user_defined.get(META_TIER, "").upper() == tier_name:
                        return f"object {b.name}/{v.name}"
                if not page.is_truncated:
                    break
                marker = page.next_key_marker
                vid_marker = page.next_version_id_marker
        return None

    def add_tier(self, ctx) -> Response:
        """PUT add-tier: {"name", "endpoint", "access_key", "secret_key",
        "bucket", "prefix"}; the name is kept upper-case."""
        if self.tiers is None:
            raise S3Error("NotImplemented", "no tier manager")
        try:
            d = json.loads(ctx.body)
            self.tiers.add(d.get("name", ""), d.get("endpoint", ""),
                           d.get("access_key", ""), d.get("secret_key", ""),
                           d.get("bucket", ""), d.get("prefix", ""))
        except (ValueError, TypeError, AttributeError) as exc:
            raise S3Error("InvalidArgument", f"bad tier: {exc}") from exc
        except StorageError as exc:
            raise S3Error("InvalidArgument", str(exc)) from exc
        return self._json({"status": "ok"})

    def list_tiers(self, ctx) -> Response:
        if self.tiers is None:
            raise S3Error("NotImplemented", "no tier manager")
        return self._json(self.tiers.list())

    def remove_tier(self, ctx) -> Response:
        """DELETE remove-tier?name=: refused while a rule of a bucket's
        lifecycle names the tier, or a version transitioned to it is
        left: the tier's entry holds the only credentials that read it.
        minio_tpu looks for the name as a substring of the lifecycle XML
        alone (ROADMAP.md Queue 3)."""
        if self.tiers is None:
            raise S3Error("NotImplemented", "no tier manager")
        name = ctx.qdict.get("name", "")
        if not name:
            raise S3Error("InvalidArgument", "name required")
        user = self._tier_user(name.upper())
        if user is not None:
            raise S3Error("InvalidArgument",
                          f"tier {name!r} is referenced by {user}")
        self.tiers.remove(name)
        return self._json({"status": "ok"})

    # --- users and policies (cmd/admin-handlers-users.go) ---

    def list_users(self, ctx) -> Response:
        return self._json({
            ak: {"status": c.status,
                 "policyName": ",".join(self.iam.user_policy.get(ak, []))}
            for ak, c in self.iam.list_users().items()})

    def add_user(self, ctx) -> Response:
        ak = ctx.qdict.get("accessKey", "")
        if not ak:
            raise S3Error("InvalidArgument", "accessKey required")
        body = json.loads(ctx.body or b"{}")
        self.iam.add_user(ak, body.get("secretKey", ""),
                          body.get("status", "on"))
        return self._json({})

    def remove_user(self, ctx) -> Response:
        self.iam.delete_user(ctx.qdict.get("accessKey", ""))
        return self._json({})

    def set_user_status(self, ctx) -> Response:
        try:
            self.iam.set_user_status(ctx.qdict.get("accessKey", ""),
                                     ctx.qdict.get("status", "on"))
        except KeyError as exc:
            raise S3Error("InvalidArgument", f"no such user {exc}") from exc
        return self._json({})

    def list_policies(self, ctx) -> Response:
        return self._json({name: p.to_dict()
                           for name, p in self.iam.policies.items()})

    def add_policy(self, ctx) -> Response:
        name = ctx.qdict.get("name", "")
        if not name:
            raise S3Error("InvalidArgument", "name required")
        try:
            self.iam.set_policy(name, Policy.parse(ctx.body))
        except (ValueError, KeyError) as exc:
            raise S3Error("MalformedXML", str(exc)) from exc
        return self._json({})

    def remove_policy(self, ctx) -> Response:
        self.iam.delete_policy(ctx.qdict.get("name", ""))
        return self._json({})

    def set_policy_mapping(self, ctx) -> Response:
        user_or_group = ctx.qdict.get("userOrGroup", "")
        policy_name = ctx.qdict.get("policyName", "")
        is_group = ctx.qdict.get("isGroup", "false") == "true"
        if not user_or_group:
            raise S3Error("InvalidArgument", "userOrGroup required")
        names = [p for p in policy_name.split(",") if p]
        self.iam.attach_policy(user_or_group, names, is_group)
        return self._json({})

    def account_info(self, ctx) -> Response:
        """GET /minio/admin/v3/accountinfo: the user buckets, each with
        its creation time."""
        buckets = [{"name": b.name, "createdNs": b.created_ns}
                   for b in self.ol.list_buckets()
                   if not b.name.startswith(".")]
        return self._json({"accountName": "minio-tpu", "buckets": buckets})

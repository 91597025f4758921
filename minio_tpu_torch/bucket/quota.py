"""Bucket quotas, the port's copy of minio_tpu/bucket/quota.py (MinIO's
cmd/bucket-quota.go: BucketQuotaSys.check over a usage cache with a
1 s TTL). The configuration is madmin's JSON, {"quota": bytes,
"quotatype": "hard" | "fifo"}, stored as `quota_json` in the bucket
metadata through the admin API.

A hard quota refuses the PUT, copy or part that would take the bucket
past its limit. A FIFO quota is stored and read back, and nothing
enforces it, as in minio_tpu: neither package trims the oldest objects.
"""

from __future__ import annotations

import json
import threading
import time

from ..utils.errors import ErrQuotaExceeded


class BucketQuotaSys:
    """The quota configuration's reader and the hard quota's admission
    check. `usage_fn()` gives {bucket: bytes}, or None while no usage
    feed exists yet (no scanner cycle has run), and then a TTL-cached
    listing walk stands in."""

    TTL_S = 1.0

    def __init__(self, object_layer, bucket_meta, usage_fn=None):
        self.ol = object_layer
        self.bm = bucket_meta
        self.usage_fn = usage_fn
        self._cache: dict[str, tuple[float, int]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def get(self, bucket: str) -> dict | None:
        raw = getattr(self.bm.get(bucket), "quota_json", "") or ""
        if not raw:
            return None
        try:
            cfg = json.loads(raw)
        except ValueError:
            return None
        quota = int(cfg.get("quota") or 0)
        if quota <= 0:
            return None
        qtype = (cfg.get("quotatype") or "hard").lower()
        return {"quota": quota, "quotatype": qtype}

    def _bucket_size(self, bucket: str) -> int:
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(bucket)
            if hit is not None and now - hit[0] < self.TTL_S:
                return hit[1]
        usage = self.usage_fn() if self.usage_fn is not None else None
        if usage is not None:
            size = int(usage.get(bucket, 0))
        else:
            # No usage feed (no scanner, or its first cycle pending): a
            # listing walk. A truncated listing leaves the usage unknown,
            # and unknown usage skips enforcement, never under-counts.
            size = 0
            try:
                res = self.ol.list_objects(bucket, prefix="",
                                           max_keys=100000)
                if getattr(res, "is_truncated", False):
                    return -1
                for oi in res.objects:
                    size += oi.size
            except Exception:  # noqa: BLE001 - no usage, no enforcement
                return -1
        with self._lock:
            self._cache[bucket] = (now, size)
        return size

    def check(self, bucket: str, incoming_size: int) -> None:
        """Raise ErrQuotaExceeded when a hard quota would be crossed;
        allow the write when the usage is unknown (MinIO skips the check
        without usage data)."""
        cfg = self.get(bucket)
        if cfg is None or cfg["quotatype"] != "hard":
            return
        size = self._bucket_size(bucket)
        if size < 0:
            return
        if size + max(0, incoming_size) >= cfg["quota"]:
            raise ErrQuotaExceeded(bucket)

    def invalidate(self, bucket: str) -> None:
        with self._lock:
            self._cache.pop(bucket, None)

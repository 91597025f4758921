"""BucketMetadataSys, the port's copy of minio_tpu/bucket/metadata.py
(MinIO's cmd/bucket-metadata-sys.go): one JSON blob a bucket, stored as
the object `buckets/<bucket>/metadata.json` of the `.minio.sys` bucket
through the object layer, and cached. The blob and its xl.meta are byte
for byte minio_tpu's. The port honours the versioning status, the
bucket policy, the tagging and SSE blobs, the lifecycle rules, the
object lock configuration and the quota; the S3 handlers refuse a bucket
whose other stored configurations (notification, replication, or a
lifecycle rule with a Transition) they would have to honour.
"""

from __future__ import annotations

import io
import json
import threading
import time
import xml.etree.ElementTree as ET

from ..iam.policy import Policy
from ..utils.errors import ErrBucketNotFound, StorageError

META_BUCKET = ".minio.sys"


class BucketMetadata:
    """All persisted per-bucket configuration blobs, raw."""

    FIELDS = (
        "policy_json", "versioning_xml", "tagging_xml", "lifecycle_xml",
        "sse_xml", "quota_json", "object_lock_xml", "notification_xml",
        "replication_xml", "replication_targets_json",
    )

    def __init__(self, name: str):
        self.name = name
        self.created_ns = time.time_ns()
        for f in self.FIELDS:
            setattr(self, f, "")

    def to_json(self) -> bytes:
        d = {"name": self.name, "created_ns": self.created_ns}
        d.update({f: getattr(self, f) for f in self.FIELDS})
        return json.dumps(d).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "BucketMetadata":
        d = json.loads(raw)
        bm = cls(d["name"])
        bm.created_ns = d.get("created_ns", 0)
        for f in cls.FIELDS:
            setattr(bm, f, d.get(f, ""))
        return bm

    # --- parsed views ---

    def _versioning_status(self) -> str:
        """The stored VersioningConfiguration's Status, read whatever its
        namespace and whitespace, as the PUT handler accepts it."""
        if not self.versioning_xml:
            return ""
        try:
            root = ET.fromstring(self.versioning_xml)
        except ET.ParseError:
            return ""
        status = ""
        for el in root.iter():
            if el.tag.endswith("Status"):
                status = (el.text or "").strip()
        return status

    @property
    def versioning_enabled(self) -> bool:
        return self._versioning_status() == "Enabled"

    @property
    def versioning_suspended(self) -> bool:
        return self._versioning_status() == "Suspended"

    def policy(self) -> Policy | None:
        if not self.policy_json:
            return None
        return Policy.parse(self.policy_json)


class BucketMetadataSys:
    """Cache and persistence of BucketMetadata."""

    def __init__(self, object_layer):
        self._ol = object_layer
        self._lock = threading.RLock()
        self._cache: dict[str, BucketMetadata] = {}

    @staticmethod
    def _path(bucket: str) -> str:
        return f"buckets/{bucket}/metadata.json"

    def get(self, bucket: str) -> BucketMetadata:
        with self._lock:
            bm = self._cache.get(bucket)
            if bm is not None:
                return bm
        try:
            raw = self._ol.get_object_bytes(META_BUCKET, self._path(bucket))
            bm = BucketMetadata.from_json(raw)
        except StorageError:
            bm = BucketMetadata(bucket)
        with self._lock:
            self._cache[bucket] = bm
        return bm

    def save(self, bm: BucketMetadata) -> None:
        raw = bm.to_json()
        try:
            self._ol.put_object(
                META_BUCKET, self._path(bm.name), io.BytesIO(raw), len(raw)
            )
        except ErrBucketNotFound:
            # .minio.sys is made on its first write.
            self._ol.make_bucket(META_BUCKET)
            self._ol.put_object(
                META_BUCKET, self._path(bm.name), io.BytesIO(raw), len(raw)
            )
        with self._lock:
            self._cache[bm.name] = bm

    def update(self, bucket: str, field: str, value: str) -> None:
        if field not in BucketMetadata.FIELDS:
            raise ValueError(f"unknown bucket metadata field {field!r}")
        bm = self.get(bucket)
        setattr(bm, field, value)
        self.save(bm)

    def delete(self, bucket: str) -> None:
        with self._lock:
            self._cache.pop(bucket, None)
        try:
            self._ol.delete_object(META_BUCKET, self._path(bucket))
        except StorageError:
            pass

    def invalidate(self, bucket: str) -> None:
        with self._lock:
            self._cache.pop(bucket, None)

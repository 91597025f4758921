"""Remote tiers and the transition and restore of objects, the port's
copy of minio_tpu/tier.py (MinIO's cmd/bucket-lifecycle.go:
transitionObject, getTransitionedObjectReader, PostRestoreObjectHandler;
the madmin tier registry).

A tier is a named remote S3 target, reached with the port's
replication.S3Client. A transition ships a version's stored bytes (after
compression and SSE: the sealed key and the markers stay in the local
metadata, so the tier never sees plaintext or a key) to
`<prefix>/<bucket>/<object>/<uuid>` on the tier's bucket, then frees the
local shard data and keeps the version's xl.meta with the tier markers.
A GET of a transitioned version streams the stored bytes back from the
tier through the usual inversion of the transforms; POST ?restore writes
a temporary local copy whose expiry the scanner enforces.

As in minio_tpu, a DELETE of a transitioned object leaves its remote
blob, and `tiers.json` holds each tier's secret key in clear (ROADMAP.md
Queue 3). Where minio_tpu reads the wall clock for a restored copy's
expiry, `expire_restored` takes the scanner's `now`. Each of the
transition, the restore and the expiry commits under the object's lock
only if the version is still the one it read (its mod time and tier
markers), where minio_tpu guards the transition alone.
"""

from __future__ import annotations

import calendar
import contextlib
import http.client
import io
import json
import socket
import tempfile
import threading
import time

from .object.types import ObjectOptions
from .replication.client import S3Client, S3Error
from .storage.fileinfo import new_uuid
from .utils.errors import (
    ErrBucketNotFound,
    ErrInvalidArgument,
    ErrRemoteTier,
    StorageError,
)

# The internal metadata of a transitioned version.
META_TIER = "x-mtpu-internal-transition-tier"
META_TIER_KEY = "x-mtpu-internal-transition-key"
META_RESTORE = "x-amz-restore"

TIERS_PATH = "config/tiers.json"
META_BUCKET = ".minio.sys"

# A transition's or a tiered GET's stored bytes stay in memory up to
# this size, then spill to a temporary file.
SPOOL_MEMORY = 8 << 20

# The errors of tier I/O, which surface as the retriable ErrRemoteTier
# (503), never as a generic 500.
_REMOTE_ERRORS = (S3Error, OSError, socket.timeout, http.client.HTTPException)


class TierConfigMgr:
    """The named remote tiers, persisted under .minio.sys as JSON."""

    def __init__(self, object_layer):
        self._ol = object_layer
        self._lock = threading.Lock()
        self._tiers: dict[str, dict] = {}

    def load(self) -> None:
        try:
            raw = self._ol.get_object_bytes(META_BUCKET, TIERS_PATH)
            with self._lock:
                self._tiers = json.loads(raw)
        except (StorageError, ValueError):
            pass

    def save(self) -> None:
        with self._lock:
            raw = json.dumps(self._tiers).encode()
        try:
            self._ol.put_object(META_BUCKET, TIERS_PATH, io.BytesIO(raw),
                                len(raw))
        except ErrBucketNotFound:
            self._ol.make_bucket(META_BUCKET)
            self._ol.put_object(META_BUCKET, TIERS_PATH, io.BytesIO(raw),
                                len(raw))

    def add(self, name: str, endpoint: str, access_key: str,
            secret_key: str, bucket: str, prefix: str = "") -> None:
        if not name or not endpoint or not bucket:
            raise ErrInvalidArgument("tier needs name, endpoint, bucket")
        with self._lock:
            self._tiers[name.upper()] = {
                "endpoint": endpoint, "access_key": access_key,
                "secret_key": secret_key, "bucket": bucket,
                "prefix": prefix.strip("/"),
            }
        self.save()

    def remove(self, name: str) -> None:
        with self._lock:
            self._tiers.pop(name.upper(), None)
        self.save()

    def get(self, name: str) -> dict | None:
        with self._lock:
            return self._tiers.get(name.upper())

    def list(self) -> dict:
        """Every tier without its secret key."""
        with self._lock:
            return {k: {kk: vv for kk, vv in v.items() if kk != "secret_key"}
                    for k, v in self._tiers.items()}

    def client(self, name: str) -> tuple[S3Client, dict]:
        t = self.get(name)
        if t is None:
            raise ErrInvalidArgument(f"unknown tier {name!r}")
        return S3Client(t["endpoint"], t["access_key"], t["secret_key"]), t


def remote_key(tier_cfg: dict, bucket: str, object_: str) -> str:
    prefix = tier_cfg.get("prefix", "")
    base = f"{bucket}/{object_}/{new_uuid()}"
    return f"{prefix}/{base}" if prefix else base


def is_transitioned(user_defined: dict) -> bool:
    return bool(user_defined.get(META_TIER))


def is_restored(user_defined: dict, now_s: float | None = None) -> bool:
    """Whether a restored copy is live locally at `now_s` (None: now)."""
    v = user_defined.get(META_RESTORE, "")
    if 'ongoing-request="false"' not in v:
        return False
    m = v.split('expiry-date="')
    if len(m) < 2:
        return False
    try:
        expiry = calendar.timegm(time.strptime(
            m[1].split('"')[0], "%a, %d %b %Y %H:%M:%S %Z"))
    except ValueError:
        return False
    return (now_s or time.time()) < expiry


def restore_header(days: int, now_s: float | None = None) -> str:
    expiry = (now_s or time.time()) + days * 86400
    stamp = time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(expiry))
    return f'ongoing-request="false", expiry-date="{stamp}"'


class TierEngine:
    """Transition, tiered reads and restore over one object layer and
    its tier registry. `metrics` receives ilm_transitioned_total and
    ilm_restored_total.

    `seconds` sums the host time of each part of the tier path since the
    engine was made: `transition_read` (the local read of the stored
    bytes into the spool, which spills to the temporary directory past
    SPOOL_MEMORY), `transition_sha256` (SigV4's payload hash of the
    spool), `transition_send` (the rest of the tier PUT: the send and
    the tier's own hash check, encode and commit), `transition_commit`
    (the local metadata commit and the parts' removal), `fetch` (a
    tiered read's or a restore's GET from the tier into a spool: the
    tier's decode and the send), `restore_write` (the restore's local
    write) and `invert` (the S3 handler's run of a fetched spool through
    the decrypt -> decompress -> range chain onto the socket)."""

    def __init__(self, object_layer, tiers: TierConfigMgr, metrics=None,
                 logger=None):
        self.ol = object_layer
        self.tiers = tiers
        self.metrics = metrics
        self.logger = logger
        self.seconds: dict[str, float] = {}
        self._seconds_lock = threading.Lock()

    @contextlib.contextmanager
    def timed(self, part: str):
        """Add the block's host seconds to `seconds[part]`."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_seconds(part, time.perf_counter() - t0)

    def add_seconds(self, part: str, dt: float) -> None:
        with self._seconds_lock:
            self.seconds[part] = self.seconds.get(part, 0.0) + dt

    def transition(self, bucket: str, object_: str, tier_name: str) -> None:
        """Move a version's stored bytes to the tier and free its local
        data. The upload runs without the object's lock; the commit
        carries the mod time read before it, so a write that raced the
        upload aborts the transition (the object stays local, and the
        next cycle tries again)."""
        client, cfg = self.tiers.client(tier_name)
        info = self.ol.get_object_info(bucket, object_)
        if is_transitioned(info.user_defined):
            return
        rkey = remote_key(cfg, bucket, object_)
        with tempfile.SpooledTemporaryFile(max_size=SPOOL_MEMORY) as spool:
            with self.timed("transition_read"):
                self.ol.get_object(bucket, object_, spool,
                                   opts=ObjectOptions())
            spool.seek(0)
            t0 = time.perf_counter()
            try:
                client.put_object(cfg["bucket"], rkey, spool)
            except _REMOTE_ERRORS as exc:
                raise ErrRemoteTier(f"tier {tier_name}: {exc}") from exc
            finally:
                self.add_seconds("transition_sha256", client.hash_seconds)
                self.add_seconds("transition_send", time.perf_counter()
                                 - t0 - client.hash_seconds)
        with self.timed("transition_commit"):
            self.ol.transition_object(
                bucket, object_, info.version_id or "",
                {META_TIER: tier_name.upper(), META_TIER_KEY: rkey},
                expected_mod_time_ns=info.mod_time_ns)
        if self.metrics is not None:
            self.metrics.inc("ilm_transitioned_total")

    def open_remote_spool(self, user_defined: dict,
                          max_memory: int = SPOOL_MEMORY):
        """(spool, tier name) of a transitioned version's stored bytes:
        a SpooledTemporaryFile at 0, which the caller closes. It spills
        to disk past `max_memory`, so a large object never sits in
        memory."""
        tier_name = user_defined.get(META_TIER, "")
        rkey = user_defined.get(META_TIER_KEY, "")
        client, cfg = self.tiers.client(tier_name)
        spool = tempfile.SpooledTemporaryFile(max_size=max_memory)
        try:
            try:
                with self.timed("fetch"):
                    client.get_object_to(cfg["bucket"], rkey, spool)
            except _REMOTE_ERRORS as exc:
                raise ErrRemoteTier(f"tier {tier_name}: {exc}") from exc
            spool.seek(0)
        except BaseException:
            spool.close()
            raise
        return spool, tier_name

    def restore(self, bucket: str, object_: str, days: int) -> None:
        """Write a temporary local copy of a transitioned version
        (PostRestoreObject), live for `days`. The fetch from the tier
        runs without the object's lock; the write carries the version's
        mod time and tier markers, so a PUT that raced the fetch aborts
        the restore (ErrInvalidArgument) and keeps its own bytes."""
        info = self.ol.get_object_info(bucket, object_)
        if not is_transitioned(info.user_defined):
            raise ErrInvalidArgument("object is not transitioned")
        spool, _ = self.open_remote_spool(info.user_defined)
        with spool, self.timed("restore_write"):
            spool.seek(0, io.SEEK_END)
            size = spool.tell()
            spool.seek(0)
            self.ol.restore_object(
                bucket, object_, info.version_id or "", spool, size,
                {META_RESTORE: restore_header(days)},
                expected_mod_time_ns=info.mod_time_ns,
                expected_meta=_tier_markers(info.user_defined))
        if self.metrics is not None:
            self.metrics.inc("ilm_restored_total")

    def expire_restored(self, bucket: str, object_: str, user_defined: dict,
                        now_s: float | None = None,
                        mod_time_ns: int | None = None) -> bool:
        """Drop a restored copy past its expiry at `now_s` (None: now)
        back to metadata only; True when it did. `user_defined` and
        `mod_time_ns` are the version as the caller saw it (a scanner's
        listing): one that changed since (a PUT of the key, a new
        restore) aborts the expiry with ErrInvalidArgument, where
        minio_tpu strips the new version's data (ROADMAP.md Queue 3)."""
        if not is_transitioned(user_defined):
            return False
        if (META_RESTORE not in user_defined
                or is_restored(user_defined, now_s)):
            return False
        info = self.ol.get_object_info(bucket, object_)
        self.ol.transition_object(
            bucket, object_, info.version_id or "", {META_RESTORE: None},
            expected_mod_time_ns=mod_time_ns,
            expected_meta={**_tier_markers(user_defined),
                           META_RESTORE: user_defined[META_RESTORE]})
        return True


def _tier_markers(user_defined: dict) -> dict:
    return {k: user_defined.get(k) for k in (META_TIER, META_TIER_KEY)}

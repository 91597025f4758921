"""ErasureServerPools, the top of the object layer, the port's copy of
the part of minio_tpu/object/pools.py the S3 server reaches (MinIO's
cmd/erasure-server-pool.go): each object goes to a pool (the one that
holds it, else the one with the most free space), listings (of latest
versions, and of every version) merge the pools' sorted walks through
the metacache, and heals go to every pool.
"""

from __future__ import annotations

import heapq
import io
import threading
import time

from ..storage.xlmeta import XLMeta
from ..utils.device import resolve_device
from ..utils.errors import (
    ErrBucketNotFound,
    ErrInvalidUploadID,
    ErrObjectNotFound,
    ErrVersionNotFound,
    StorageError,
)
from .metacache import ListingLoop, MetacacheManager, StaleListingCache
from ..storage.fileinfo import FileInfo
from .sets import ErasureSets
from .types import (
    ListObjectsInfo,
    ListObjectVersionsInfo,
    ObjectInfo,
    ObjectOptions,
)


def _check_progress(seen: set, state: tuple, bucket: str, marker: str):
    """Raise ListingLoop if a listing call is back in `state`: the page
    it asks for next depends only on the cursor and the entries the walk
    has pulled, and what it has gathered only grows, so a state seen
    twice comes round again and again (ROADMAP Queue 3)."""
    if state in seen:
        raise ListingLoop(f"listing of {bucket!r} from {marker!r} goes "
                          f"round at {state[1]!r}")
    seen.add(state)


class ErasureServerPools:
    """The object layer over one or more ErasureSets pools. `device` is
    where every set runs its kernels: it defaults to the card, raises
    when there is none, and must be the device the sets were made for."""

    _BUCKET_SEEN_TTL_S = 2.0

    def __init__(self, pools: list[ErasureSets], device="cuda"):
        if not pools:
            raise ValueError("need at least one pool")
        self.device = resolve_device(device)
        for pool in pools:
            for s in pool.sets:
                if s.device != self.device:
                    raise ValueError(f"a set of pool {pool.pool_index} runs "
                                     f"on {s.device}, not {self.device}")
        self.pools = pools
        # Listing: a per-bucket mutation generation, bumped on every
        # write and delete, keys the process-local cache of sorted
        # listing streams (cmd/metacache-server-pool.go:59).
        self._list_gen: dict[str, int] = {}
        self._gen_lock = threading.Lock()
        self._metacache = MetacacheManager()
        # The DataUpdateTracker (background/tracker.py) the server sets:
        # every write marks its bucket, so the scanner skips unchanged
        # buckets.
        self.update_tracker = None
        # Buckets seen to exist lately: a positive lasts a moment, so an
        # object call does not stat the bucket on every disk; a negative
        # is never kept, and delete_bucket forgets the bucket.
        self._bucket_seen: dict[str, float] = {}
        self._bucket_seen_lock = threading.Lock()

    def close(self) -> None:
        """Drop the listing caches and their spill directory."""
        self._metacache.close()

    def _bump_gen(self, bucket: str) -> None:
        self.invalidate_listings(bucket)
        if self.update_tracker is not None:
            self.update_tracker.mark(bucket)

    def invalidate_listings(self, bucket: str) -> None:
        """Drop the bucket's cached listings (a mutation made elsewhere):
        no tracker mark."""
        with self._gen_lock:
            self._list_gen[bucket] = self._list_gen.get(bucket, 0) + 1

    # --- pool routing ---

    def _pool_with_object(self, bucket: str, object_: str,
                          opts: ObjectOptions | None) -> int | None:
        for i, pool in enumerate(self.pools):
            try:
                pool.get_object_info(bucket, object_, opts)
                return i
            except (ErrObjectNotFound, ErrVersionNotFound):
                continue
        return None

    def _pool_for_put(self, bucket: str, object_: str,
                      opts: ObjectOptions | None) -> int:
        """An object keeps its pool; a new one goes to the pool with the
        most free space (getPoolIdx, cmd/erasure-server-pool.go:293)."""
        if len(self.pools) == 1:
            return 0
        existing = self._pool_with_object(bucket, object_, opts)
        if existing is not None:
            return existing
        best, best_free = 0, -1
        for i, pool in enumerate(self.pools):
            free = 0
            for disk in pool.disks:
                if disk is None:
                    continue
                try:
                    free += disk.disk_info().free
                except (StorageError, OSError):
                    continue
            if free > best_free:
                best, best_free = i, free
        return best

    # --- buckets ---

    def make_bucket(self, bucket: str):
        for pool in self.pools:
            pool.make_bucket(bucket)
        if self.update_tracker is not None:
            self.update_tracker.mark(bucket)

    def delete_bucket(self, bucket: str, force: bool = False):
        self._forget_bucket(bucket)
        for pool in self.pools:
            pool.delete_bucket(bucket, force=force)
        # Forget it again: a _check_bucket that raced the deletes may
        # have cached the bucket while it was still there.
        self._forget_bucket(bucket)
        self._metacache.invalidate_bucket(bucket)
        self._list_gen.pop(bucket, None)
        if self.update_tracker is not None:
            self.update_tracker.mark(bucket)

    def bucket_exists(self, bucket: str) -> bool:
        return any(p.bucket_exists(bucket) for p in self.pools)

    def get_bucket_info(self, bucket: str):
        for pool in self.pools:
            for b in pool.list_buckets():
                if b.name == bucket:
                    return b
        raise ErrBucketNotFound(bucket)

    def list_buckets(self):
        seen = {}
        for pool in self.pools:
            for b in pool.list_buckets():
                seen.setdefault(b.name, b)
        return [seen[k] for k in sorted(seen)]

    def _check_bucket(self, bucket: str):
        now = time.monotonic()
        with self._bucket_seen_lock:
            seen = self._bucket_seen.get(bucket, 0.0)
        if now - seen < self._BUCKET_SEEN_TTL_S:
            return
        if not self.bucket_exists(bucket):
            raise ErrBucketNotFound(bucket)
        with self._bucket_seen_lock:
            self._bucket_seen[bucket] = now

    def _forget_bucket(self, bucket: str):
        with self._bucket_seen_lock:
            self._bucket_seen.pop(bucket, None)

    # --- objects ---

    def put_object(self, bucket, object_, reader, size, opts=None):
        self._check_bucket(bucket)
        idx = self._pool_for_put(bucket, object_, opts)
        oi = self.pools[idx].put_object(bucket, object_, reader, size, opts)
        self._bump_gen(bucket)
        return oi

    def get_object(self, bucket, object_, writer, offset=0, length=-1,
                   opts=None):
        self._check_bucket(bucket)
        last_exc = None
        for pool in self.pools:
            try:
                return pool.get_object(bucket, object_, writer, offset,
                                       length, opts)
            except (ErrObjectNotFound, ErrVersionNotFound) as exc:
                last_exc = exc
        raise last_exc or ErrObjectNotFound(f"{bucket}/{object_}")

    def get_object_bytes(self, bucket, object_, offset=0, length=-1,
                         opts=None) -> bytes:
        buf = io.BytesIO()
        self.get_object(bucket, object_, buf, offset, length, opts)
        return buf.getvalue()

    def get_object_info(self, bucket, object_, opts=None) -> ObjectInfo:
        self._check_bucket(bucket)
        last_exc = None
        for pool in self.pools:
            try:
                return pool.get_object_info(bucket, object_, opts)
            except (ErrObjectNotFound, ErrVersionNotFound) as exc:
                last_exc = exc
        raise last_exc or ErrObjectNotFound(f"{bucket}/{object_}")

    def delete_object(self, bucket, object_, opts=None):
        self._check_bucket(bucket)
        last_exc = None
        for pool in self.pools:
            try:
                out = pool.delete_object(bucket, object_, opts)
                self._bump_gen(bucket)
                return out
            except (ErrObjectNotFound, ErrVersionNotFound) as exc:
                last_exc = exc
        raise last_exc or ErrObjectNotFound(f"{bucket}/{object_}")

    def delete_objects(self, bucket, objects, opts=None):
        return [self._del_one(bucket, o, opts) for o in objects]

    def _del_one(self, bucket, o, opts):
        try:
            self.delete_object(bucket, o, opts)
            return None
        except StorageError as exc:
            return exc

    def update_object_metadata(self, bucket, object_, version_id, updates,
                               replace_user_meta=False):
        last_exc = None
        for pool in self.pools:
            try:
                return pool.update_object_metadata(
                    bucket, object_, version_id, updates, replace_user_meta)
            except (ErrObjectNotFound, ErrVersionNotFound) as exc:
                last_exc = exc
        raise last_exc or ErrObjectNotFound(f"{bucket}/{object_}")

    # --- listing (cmd/erasure-server-pool.go:876,
    # cmd/metacache-server-pool.go:59-239) ---

    def _merged_stream_factory(self, bucket: str, prefix: str):
        """A factory of the de-duplicated sorted (name, xl.meta) stream
        over the pools, the one source the listing cache pages."""
        def factory():
            streams = [p.list_objects_raw(bucket, prefix)
                       for p in self.pools]
            merged = heapq.merge(*streams, key=lambda t: t[0])

            def dedup():
                last = None
                for name, blob in merged:
                    if name == last:
                        continue
                    last = name
                    yield name, blob

            return dedup()

        return factory

    def list_objects(self, bucket: str, prefix: str = "", marker: str = "",
                     delimiter: str = "",
                     max_keys: int = 1000) -> ListObjectsInfo:
        self._check_bucket(bucket)
        if max_keys <= 0:
            return ListObjectsInfo()  # S3: max-keys 0 is empty, not truncated
        gen = self._list_gen.get(bucket, 0)
        stream_factory = self._merged_stream_factory(bucket, prefix)
        out = ListObjectsInfo()
        prefixes: set[str] = set()
        cursor = marker
        seen = set()
        while True:
            # Fetch one more than a page: delimiter roll-ups and delete
            # markers consume entries without giving keys.
            try:
                entries, exhausted, pulled = self._metacache.page(
                    bucket, prefix, gen, cursor, max_keys + 1,
                    stream_factory)
            except StaleListingCache:
                # Raced a mutation: the next page builds a fresh cache.
                gen = self._list_gen.get(bucket, 0)
                continue
            _check_progress(seen, (gen, cursor, pulled, len(out.objects),
                                   len(prefixes)), bucket, marker)
            for name, meta_blob in entries:
                cursor = name
                if delimiter:
                    rest = name[len(prefix):]
                    if delimiter in rest:
                        prefixes.add(
                            prefix + rest.split(delimiter, 1)[0] + delimiter)
                        continue
                try:
                    fi = XLMeta.from_bytes(meta_blob).to_file_info(
                        bucket, name, None)
                except (ValueError, KeyError, StorageError):
                    continue  # an unreadable journal is left out
                if fi.deleted:
                    continue  # the latest version is a delete marker
                if len(out.objects) >= max_keys:
                    out.is_truncated = True
                    out.next_marker = (out.objects[-1].name if out.objects
                                       else name)
                    break
                out.objects.append(ObjectInfo.from_file_info(fi, bucket,
                                                             name))
            if out.is_truncated or exhausted or not entries:
                break
        out.prefixes = sorted(prefixes)
        return out

    def list_object_versions(self, bucket: str, prefix: str = "",
                             key_marker: str = "",
                             version_id_marker: str = "",
                             delimiter: str = "",
                             max_keys: int = 1000) -> ListObjectVersionsInfo:
        """ListObjectVersions: every version, objects and delete markers,
        keys ascending and each key's versions newest first
        (cmd/bucket-listobjects-handlers.go:214-352), paged from the same
        metacache stream as list_objects: each xl.meta blob holds the
        key's whole journal."""
        self._check_bucket(bucket)
        if max_keys <= 0:
            return ListObjectVersionsInfo()  # S3: empty, not truncated
        gen = self._list_gen.get(bucket, 0)
        stream_factory = self._merged_stream_factory(bucket, prefix)
        out = ListObjectVersionsInfo()
        prefixes: set[str] = set()
        # Page from just before key_marker, so that version_id_marker can
        # resume inside that key.
        cursor = key_marker[:-1] if key_marker else ""
        vid_skip = version_id_marker
        truncated = False
        seen = set()
        while not truncated:
            try:
                entries, exhausted, pulled = self._metacache.page(
                    bucket, prefix, gen, cursor, max_keys + 1,
                    stream_factory)
            except StaleListingCache:
                gen = self._list_gen.get(bucket, 0)
                continue
            _check_progress(seen, (gen, cursor, pulled, len(out.versions),
                                   len(prefixes), vid_skip), bucket,
                            key_marker)
            for name, meta_blob in entries:
                cursor = name
                if key_marker and name < key_marker:
                    continue
                if key_marker and name == key_marker and not vid_skip:
                    continue  # the marker key was listed whole
                if delimiter:
                    rest = name[len(prefix):]
                    if delimiter in rest:
                        prefixes.add(
                            prefix + rest.split(delimiter, 1)[0] + delimiter)
                        continue
                try:
                    meta = XLMeta.from_bytes(meta_blob)
                except StorageError:
                    continue  # an unreadable journal is left out
                versions = meta.versions
                if key_marker and name == key_marker and vid_skip:
                    # Resume after version_id_marker within this key.
                    idx = next((i + 1 for i, v in enumerate(versions)
                                if (v["vid"] or "null") == vid_skip),
                               len(versions))
                    versions = versions[idx:]
                    vid_skip = ""
                for v in versions:
                    if len(out.versions) >= max_keys:
                        truncated = out.is_truncated = True
                        last = out.versions[-1] if out.versions else None
                        out.next_key_marker = last.name if last else name
                        out.next_version_id_marker = (
                            (last.version_id or "null") if last else "")
                        break
                    fi = FileInfo.from_dict(v)
                    fi.volume, fi.name = bucket, name
                    fi.is_latest = meta.versions[0]["vid"] == v["vid"]
                    out.versions.append(ObjectInfo.from_file_info(
                        fi, bucket, name, versioned=True))
                if truncated:
                    break
            if truncated or exhausted or not entries:
                break
        out.prefixes = sorted(prefixes)
        return out

    # --- multipart: a new upload goes where a PUT would; an upload is
    # found by its id in whichever pool holds it ---

    def new_multipart_upload(self, bucket, object_, opts=None):
        self._check_bucket(bucket)
        idx = self._pool_for_put(bucket, object_, opts)
        return self.pools[idx].new_multipart_upload(bucket, object_, opts)

    def _pool_for_upload(self, bucket, object_, upload_id):
        for pool in self.pools:
            try:
                pool.get_hashed_set(object_)._upload_fi(bucket, object_,
                                                        upload_id)
                return pool
            except ErrInvalidUploadID:
                continue
        raise ErrInvalidUploadID(upload_id)

    def put_object_part(self, bucket, object_, upload_id, part_number,
                        reader, size, opts=None):
        pool = self._pool_for_upload(bucket, object_, upload_id)
        return pool.put_object_part(bucket, object_, upload_id, part_number,
                                    reader, size, opts)

    def list_object_parts(self, bucket, object_, upload_id, part_marker=0,
                          max_parts=1000):
        pool = self._pool_for_upload(bucket, object_, upload_id)
        return pool.list_object_parts(bucket, object_, upload_id,
                                      part_marker, max_parts)

    def list_multipart_uploads(self, bucket, prefix=""):
        out = []
        for pool in self.pools:
            out.extend(pool.list_multipart_uploads(bucket, prefix))
        return out

    def abort_multipart_upload(self, bucket, object_, upload_id):
        pool = self._pool_for_upload(bucket, object_, upload_id)
        return pool.abort_multipart_upload(bucket, object_, upload_id)

    def complete_multipart_upload(self, bucket, object_, upload_id, parts,
                                  opts=None):
        pool = self._pool_for_upload(bucket, object_, upload_id)
        oi = pool.complete_multipart_upload(bucket, object_, upload_id,
                                            parts, opts)
        self._bump_gen(bucket)
        return oi

    # --- heal ---

    def heal_object(self, bucket, object_, version_id="",
                    remove_dangling=False):
        results = []
        for pool in self.pools:
            try:
                results.append(pool.heal_object(bucket, object_, version_id,
                                                remove_dangling))
            except (ErrObjectNotFound, ErrVersionNotFound):
                continue
        if not results:
            raise ErrObjectNotFound(f"{bucket}/{object_}")
        # Heal may rewrite xl.meta or purge a dangling object: listings
        # see it.
        self._bump_gen(bucket)
        return results[0] if len(results) == 1 else results

    def heal_bucket(self, bucket):
        return [p.heal_bucket(bucket) for p in self.pools]

    def health(self) -> bool:
        """Whether the cluster takes writes: every set of every pool has
        write quorum of its disks online (Health, cmd/erasure-server-
        pool.go:1705-1786, cut to the quorum test)."""
        for pool in self.pools:
            for es in pool.sets:
                online = sum(1 for d in es.disks
                             if d is not None and d.is_online())
                write_quorum = len(es.disks) - es.default_parity
                if es.default_parity == len(es.disks) - es.default_parity:
                    write_quorum += 1
                if online < write_quorum:
                    return False
        return True

    def heal_format(self):
        for pool in self.pools:
            pool.init_format()

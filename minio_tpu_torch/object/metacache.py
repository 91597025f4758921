"""Metacache: resumable listing streams, the port's copy of
minio_tpu/object/metacache.py (MinIO's cmd/metacache-server-pool.go,
metacache-set.go and metacache-stream.go, reshaped for one process).

The serving process owns the merged (name, xl.meta) stream of a (bucket,
prefix), so the cache is local to it: entry names and spill-file offsets
stay in memory, the metadata blobs spill to a local file, and the live
merge iterator is kept, so a later page continues the walk instead of
walking again from the start. The object layer bumps a per-bucket
generation on every mutation, and a cache built at generation G is
dropped once the bucket moves on. Listing a bucket touches each disk
once whatever the page count; a page costs O(log n + page).
"""

from __future__ import annotations

import bisect
import os
import shutil
import tempfile
import threading
import time
import uuid

from ..utils.errors import StorageError


class StaleListingCache(Exception):
    """Raised when a page request races a cache invalidation/eviction;
    the caller re-requests and gets a fresh cache."""


class ListingLoop(StorageError):
    """A listing call came back to a state it had been in: the walk
    order (directory entries sorted with their trailing slash) is not
    the names' byte order, so paging by name can go round for ever.
    minio_tpu's call never returns there; the port's ends with this."""


class ListingCache:
    """One (bucket, prefix) sorted listing: pull-through spill cache."""

    def __init__(self, stream, spill_dir: str):
        self._closed = False
        self._stream = stream  # live iterator of (name, meta_blob)
        self._names: list[str] = []
        self._offsets: list[tuple[int, int]] = []  # (file_off, blob_len)
        self._path = os.path.join(spill_dir, f"mcache-{uuid.uuid4().hex}")
        self._file = open(self._path, "w+b")
        self._write_off = 0
        self.complete = False
        self.last_used = time.monotonic()
        self._lock = threading.Lock()

    def _pull(self) -> bool:
        """Advance the underlying walk by one entry. False on exhaustion."""
        try:
            name, blob = next(self._stream)
        except StopIteration:
            self.complete = True
            return False
        blob = bytes(blob)
        self._file.seek(self._write_off)
        self._file.write(blob)
        self._names.append(name)
        self._offsets.append((self._write_off, len(blob)))
        self._write_off += len(blob)
        return True

    def page(self, marker: str,
             count: int) -> tuple[list[tuple[str, bytes]], bool, int]:
        """Entries strictly after `marker`, up to `count` (+1 lookahead is
        the caller's concern). Returns (entries, exhausted_after, the
        entries pulled from the walk so far)."""
        # One lock a listing: a seek and its read must not interleave.
        with self._lock:
            if self._closed:
                raise StaleListingCache()
            self.last_used = time.monotonic()
            # Advance the walk until `count` entries past the marker exist
            # (the marker itself may lie beyond everything pulled so far —
            # recompute its insertion point after every pull).
            while True:
                start = bisect.bisect_right(self._names, marker) if marker else 0
                if self.complete or len(self._names) >= start + count:
                    break
                self._pull()
            out = []
            for i in range(start, min(start + count, len(self._names))):
                off, ln = self._offsets[i]
                self._file.seek(off)
                out.append((self._names[i], self._file.read(ln)))
            exhausted = self.complete and start + count >= len(self._names)
            return out, exhausted, len(self._names)

    def close(self):
        # Serialized against in-flight page() reads; late pages observe
        # _closed and raise StaleListingCache instead of touching the
        # closed spill file.
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._file.close()
                os.unlink(self._path)
            except OSError:
                pass


class MetacacheManager:
    """LRU of ListingCaches keyed by (bucket, prefix, generation)."""

    MAX_CACHES = 32

    def __init__(self):
        self._dir = tempfile.mkdtemp(prefix="mtpu-metacache-")
        self._caches: dict[tuple[str, str], tuple[int, ListingCache]] = {}
        self._lock = threading.Lock()

    def page(self, bucket: str, prefix: str, generation: int,
             marker: str, count: int, stream_factory):
        """Serve one page, creating/refreshing the cache as needed.

        `stream_factory()` must return a fresh sorted (name, blob)
        iterator for (bucket, prefix) — only called on cache miss."""
        key = (bucket, prefix)
        with self._lock:
            hit = self._caches.get(key)
            if hit is not None and hit[0] == generation:
                cache = hit[1]
            else:
                if hit is not None:
                    hit[1].close()
                cache = ListingCache(stream_factory(), self._dir)
                self._caches[key] = (generation, cache)
                self._evict_locked()
        return cache.page(marker, count)

    def invalidate_bucket(self, bucket: str):
        with self._lock:
            for key in [k for k in self._caches if k[0] == bucket]:
                self._caches.pop(key)[1].close()

    def _evict_locked(self):
        while len(self._caches) > self.MAX_CACHES:
            victim = min(
                self._caches.items(), key=lambda kv: kv[1][1].last_used
            )[0]
            self._caches.pop(victim)[1].close()

    def close(self):
        with self._lock:
            for _, c in self._caches.values():
                c.close()
            self._caches.clear()
        shutil.rmtree(self._dir, ignore_errors=True)

"""The data update tracker, the port's copy of minio_tpu/background/
tracker.py: a persisted bloom filter of changed paths that lets the
scanner skip unchanged buckets (MinIO's dataUpdateTracker,
cmd/data-update-tracker.go:62).

Writes mark their bucket (and optionally bucket/object) in the current
filter. At the start of each scan cycle the scanner calls advance(): the
current filter becomes the cycle's snapshot (what changed since the last
scan) and a fresh one begins. A false positive costs an extra scan,
never a missed change; a lost or corrupt saved filter means "everything
changed" (a full scan).
"""

from __future__ import annotations

import base64
import hashlib
import io
import json
import threading
import zlib

from ..utils.errors import ErrBucketNotFound, StorageError

# 2^20 bits, 7 hashes: under 1% false positives up to ~100k paths.
_BITS = 1 << 20
_HASHES = 7


class _Bloom:
    def __init__(self, bits: bytes | None = None):
        self.bits = bytearray(bits) if bits else bytearray(_BITS // 8)

    def _positions(self, key: str):
        h = hashlib.sha256(key.encode()).digest()
        a = int.from_bytes(h[:8], "little")
        b = int.from_bytes(h[8:16], "little") | 1
        for i in range(_HASHES):
            yield (a + i * b) % _BITS

    def add(self, key: str) -> None:
        for p in self._positions(key):
            self.bits[p >> 3] |= 1 << (p & 7)

    def merge(self, other: "_Bloom") -> None:
        for i, b in enumerate(other.bits):
            self.bits[i] |= b

    def __contains__(self, key: str) -> bool:
        return all(self.bits[p >> 3] & (1 << (p & 7))
                   for p in self._positions(key))


class DataUpdateTracker:
    """The current and last-cycle filters, saved under .minio.sys through
    the object layer."""

    PATH = "scanner/update-tracker.json"
    META_BUCKET = ".minio.sys"

    def __init__(self, object_layer=None):
        self._ol = object_layer
        self._lock = threading.Lock()
        self._current = _Bloom()
        self._snapshot: _Bloom | None = None  # None: unknown, scan all
        self.marks = 0

    def mark(self, bucket: str, object_: str = "") -> None:
        """The write path's hook."""
        with self._lock:
            self._current.add(bucket)
            if object_:
                self._current.add(f"{bucket}/{object_}")
            self.marks += 1

    def advance(self) -> None:
        """Start a cycle: the changes so far become the snapshot the
        scanner consults, and new writes land in a fresh filter."""
        with self._lock:
            self._snapshot = self._current
            self._current = _Bloom()

    def restore(self) -> None:
        """Abort a cycle: fold its snapshot back into the live filter, so
        a failed scan cannot swallow change marks."""
        with self._lock:
            if self._snapshot is not None:
                self._current.merge(self._snapshot)
                self._snapshot = None

    def changed_since_last_cycle(self, bucket: str,
                                 object_: str = "") -> bool:
        """True when the path may have changed since the last scan, or
        when that is unknown (a fresh start, a lost filter)."""
        with self._lock:
            if self._snapshot is None:
                return True
            key = f"{bucket}/{object_}" if object_ else bucket
            # Writes during this cycle count too.
            return key in self._snapshot or key in self._current

    def _blob(self) -> bytes:
        with self._lock:
            return json.dumps({"current": base64.b64encode(
                zlib.compress(bytes(self._current.bits))).decode()}).encode()

    def save(self) -> None:
        if self._ol is None:
            return
        blob = self._blob()
        try:
            self._ol.put_object(self.META_BUCKET, self.PATH,
                                io.BytesIO(blob), len(blob))
        except ErrBucketNotFound:
            try:
                self._ol.make_bucket(self.META_BUCKET)
                self._ol.put_object(self.META_BUCKET, self.PATH,
                                    io.BytesIO(blob), len(blob))
            except StorageError:
                pass
        except StorageError:
            pass

    def load(self) -> None:
        if self._ol is None:
            return
        try:
            raw = self._ol.get_object_bytes(self.META_BUCKET, self.PATH)
            bits = zlib.decompress(base64.b64decode(json.loads(raw)["current"]))
            if len(bits) != _BITS // 8:
                raise ValueError("tracker size mismatch")
            with self._lock:
                # Marks from before the restart: changed since the last
                # completed scan.
                self._current = _Bloom(bits)
        except (StorageError, ValueError, KeyError):
            pass  # unknown history: the first cycle scans everything

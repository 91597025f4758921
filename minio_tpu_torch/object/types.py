"""Object-layer API types, the port's copy of the part of
minio_tpu/object/types.py that PutObject, GetObject, DeleteObject,
HealObject, ListObjects, ListObjectVersions and the multipart calls
use (MinIO's cmd/object-api-datatypes.go).
"""

from __future__ import annotations

import hashlib
import queue
import threading
import weakref
from dataclasses import dataclass, field

from ..pipeline.buffers import copy_add
from ..storage.fileinfo import FileInfo
from ..utils import fanout


@dataclass
class ObjectOptions:
    """Per-call options (ObjectOptions)."""

    version_id: str = ""
    versioned: bool = False
    version_suspended: bool = False
    user_defined: dict = field(default_factory=dict)
    delete_marker: bool = False
    no_lock: bool = False
    part_number: int = 0
    # Commit mod time in ns; 0 stamps the time of the commit.
    mod_time_ns: int = 0
    # Hex MD5 the client declared (Content-MD5): checked against the
    # streamed digest before the commit, so a mismatch leaves nothing.
    want_md5_hex: str = ""
    # Parity from the storage class; None = the set's default.
    parity: int | None = None
    # GET: the ETag the response headers advertised; a locked read that
    # finds another object fails with no byte written.
    expected_etag: str = ""
    # The request's erasure codec id (x-mtpu-codec; "auto" re-enables
    # auto-selection); "" lets registry.select_codec choose.
    codec: str = ""


@dataclass
class ObjectInfo:
    """Object metadata as callers see it (ObjectInfo)."""

    bucket: str = ""
    name: str = ""
    mod_time_ns: int = 0
    size: int = 0
    etag: str = ""
    version_id: str = ""
    is_latest: bool = True
    delete_marker: bool = False
    content_type: str = ""
    user_defined: dict = field(default_factory=dict)
    parity_blocks: int = 0
    data_blocks: int = 0
    num_versions: int = 0

    @classmethod
    def from_file_info(cls, fi: FileInfo, bucket: str, object_: str,
                       versioned: bool = False) -> "ObjectInfo":
        version_id = fi.version_id
        if versioned and not version_id:
            version_id = "null"
        return cls(
            bucket=bucket,
            name=object_,
            mod_time_ns=fi.mod_time_ns,
            size=fi.size,
            etag=fi.metadata.get("etag", ""),
            version_id=version_id,
            is_latest=fi.is_latest,
            delete_marker=fi.deleted,
            content_type=fi.metadata.get("content-type", ""),
            user_defined={k: v for k, v in fi.metadata.items()
                          if k != "etag"},
            parity_blocks=fi.erasure.parity_blocks,
            data_blocks=fi.erasure.data_blocks,
            num_versions=fi.num_versions,
        )


@dataclass
class ListObjectsInfo:
    is_truncated: bool = False
    next_marker: str = ""
    objects: list[ObjectInfo] = field(default_factory=list)
    prefixes: list[str] = field(default_factory=list)


@dataclass
class ListObjectVersionsInfo:
    """A ListObjectVersions page (ListObjectVersionsInfo): objects and
    delete markers, keys ascending, each key's versions newest first."""

    is_truncated: bool = False
    next_key_marker: str = ""
    next_version_id_marker: str = ""
    versions: list[ObjectInfo] = field(default_factory=list)
    prefixes: list[str] = field(default_factory=list)


@dataclass
class MultipartInfo:
    bucket: str = ""
    object: str = ""
    upload_id: str = ""
    user_defined: dict = field(default_factory=dict)


@dataclass
class PartInfo:
    part_number: int = 0
    etag: str = ""
    size: int = 0
    actual_size: int = 0
    mod_time_ns: int = 0


@dataclass
class CompletePart:
    part_number: int
    etag: str


@dataclass
class BucketInfo:
    name: str
    created_ns: int


def compute_etag(data_md5: bytes | None, parts: int = 0) -> str:
    """S3 ETag: hex MD5, or the multipart MD5 of MD5s with a -N suffix."""
    if data_md5 is None:
        return ""
    if parts:
        return data_md5.hex() + f"-{parts}"
    return data_md5.hex()


def compute_parts_etag(part_md5s: list[bytes]) -> str:
    """The S3 ETag of a multipart object: the MD5 of the concatenated
    raw 16-byte part digests, suffixed -N for N parts (N = 1 included)."""
    return (hashlib.md5(b"".join(part_md5s)).hexdigest()
            + f"-{len(part_md5s)}")


class TeeMD5Reader:
    """A reader that takes the MD5 and size of the bytes that pass
    through it, the object's ETag (MinIO's hash.Reader).

    On a multi-core host the MD5 runs on a hashing thread of its own,
    fed through a bounded queue, so hashing batch N overlaps encoding and
    writing batch N+1 (hashlib releases the GIL for updates over 2 KiB).
    The thread starts lazily, on the first buffer: the pipelined encode
    calls delegate_hashing() before it reads, and hashes in a stage of
    its own. On one core, or below PIPELINE_MIN_SIZE, it hashes inline."""

    # At most this many buffers in flight: a slow hasher applies
    # backpressure instead of buffering the object.
    QUEUE_DEPTH = 4
    # Below this the MD5 takes microseconds: a thread and its hand-offs
    # would cost more than they could overlap.
    PIPELINE_MIN_SIZE = 4 << 20

    def __init__(self, src, pipelined: bool | None = None,
                 size: int | None = None):
        self._src = src
        self._md5 = hashlib.md5()
        self.bytes_read = 0
        if pipelined is None:
            big = size is None or size < 0 or size >= self.PIPELINE_MIN_SIZE
            pipelined = big and not fanout.SINGLE_CORE
        self._queue = None
        self._want_pipeline = bool(pipelined)

    def _start_worker(self):
        q = queue.Queue(maxsize=self.QUEUE_DEPTH)
        self._queue = q
        # The worker closes over (queue, md5), not self, so an abandoned
        # reader is collected and its finalizer stops the thread.
        self._worker = threading.Thread(
            target=self._hash_loop, args=(q, self._md5),
            name="mtpu-md5", daemon=True)
        self._worker.start()
        self._finalizer = weakref.finalize(self, q.put, None)

    @staticmethod
    def _hash_loop(q, md5):
        while True:
            buf = q.get()
            try:
                if buf is None:
                    return
                md5.update(buf)
            finally:
                q.task_done()

    def _ingest(self, buf):
        if self._want_pipeline and self._queue is None:
            self._start_worker()
        if self._queue is not None:
            self._queue.put(buf)
        else:
            self._md5.update(buf)

    def read(self, n: int = -1) -> bytes:
        buf = self._src.read(n)
        if buf:
            self._ingest(buf)  # bytes are immutable: no copy needed
            self.bytes_read += len(buf)
        return buf

    def readinto(self, b) -> int:
        """Fill `b` from the source, by its readinto where it has one."""
        view = memoryview(b).cast("B")
        src_readinto = getattr(self._src, "readinto", None)
        if src_readinto is not None:
            n = src_readinto(view)
            if n:
                # The caller owns (and reuses) `b`: the hashing thread
                # gets a snapshot. Decided on _want_pipeline, since the
                # lazy worker starts inside _ingest.
                if self._want_pipeline or self._queue is not None:
                    copy_add("put.md5_snapshot", n)
                    self._ingest(bytes(view[:n]))
                else:
                    self._ingest(view[:n])
                self.bytes_read += n
            return n or 0
        buf = self._src.read(len(view))
        n = len(buf)
        if n:
            view[:n] = buf
            self._ingest(buf)
            self.bytes_read += n
        return n

    def delegate_hashing(self):
        """Hand hashing to a pipeline stage: returns (inner_source,
        md5_update) and stops this reader's own hashing (and its thread).
        The caller feeds md5_update exactly the source's bytes in order;
        md5_hex() then returns the digest as usual. bytes_read stops
        advancing."""
        self._want_pipeline = False
        if self._queue is not None:
            self._stop_worker()
        return self._src, self._md5.update

    def _stop_worker(self):
        self._finalizer.detach()
        self._queue.put(None)
        self._worker.join()
        self._queue = None

    def md5_hex(self) -> str:
        if self._queue is not None:
            self._stop_worker()  # drains the queue once
        return self._md5.hexdigest()

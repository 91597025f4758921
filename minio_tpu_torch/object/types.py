"""Object-layer API types, the port's copy of the part of
minio_tpu/object/types.py that PutObject, GetObject, DeleteObject,
HealObject, ListObjects and the multipart calls use (MinIO's
cmd/object-api-datatypes.go).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..storage.fileinfo import FileInfo


@dataclass
class ObjectOptions:
    """Per-call options (ObjectOptions)."""

    version_id: str = ""
    versioned: bool = False
    user_defined: dict = field(default_factory=dict)
    no_lock: bool = False
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
    """A reader that takes the MD5 of the bytes that pass through it, the
    object's ETag (MinIO's hash.Reader). Hashing is inline on the
    caller's thread; minio_tpu's overlaps it on a thread of its own."""

    def __init__(self, src):
        self._src = src
        self._md5 = hashlib.md5()

    def read(self, n: int = -1) -> bytes:
        buf = self._src.read(n)
        self._md5.update(buf)
        return buf

    def md5_hex(self) -> str:
        return self._md5.hexdigest()

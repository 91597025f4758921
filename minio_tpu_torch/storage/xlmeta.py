"""xl.meta: the per-object version journal stored beside the shard data
on every disk. The port's copy of minio_tpu/storage/xlmeta.py: the magic
"XLT1", then a msgpack document {"ver": 1, "versions": [...]} holding
FileInfo.to_dict() entries newest first by mod time, inline data
included. It packs with the port's own msgpack subset (`_msgpack`), byte
for byte what minio_tpu writes.
"""

from __future__ import annotations

from ..utils.errors import ErrCorruptedFormat, ErrFileVersionNotFound
from . import _msgpack
from .fileinfo import FileInfo

XL_META_MAGIC = b"XLT1"
XL_META_VERSION = 1

# Internal id of the "null" (unversioned) version. Clients address it as
# the literal "null"; the journal stores it with an empty id.
NULL_VERSION_ID = ""


def _normalize_vid(version_id: str | None) -> str | None:
    return NULL_VERSION_ID if version_id == "null" else version_id


class XLMeta:
    """In-memory xl.meta: a list of version dicts, newest first."""

    def __init__(self):
        self.versions: list[dict] = []  # FileInfo.to_dict() entries

    def to_bytes(self) -> bytes:
        doc = {"ver": XL_META_VERSION, "versions": self.versions}
        return XL_META_MAGIC + _msgpack.packb(doc)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "XLMeta":
        if len(buf) < 4 or buf[:4] != XL_META_MAGIC:
            raise ErrCorruptedFormat("bad xl.meta magic")
        try:
            doc = _msgpack.unpackb(memoryview(buf)[4:])
        except (ValueError, TypeError) as exc:  # UnicodeDecodeError too
            raise ErrCorruptedFormat(f"xl.meta unpack: {exc}") from exc
        if not isinstance(doc, dict) or doc.get("ver") != XL_META_VERSION:
            raise ErrCorruptedFormat("unknown xl.meta version")
        m = cls()
        m.versions = list(doc["versions"])
        return m

    # Version journal operations (AddVersion / DeleteVersion).

    def _sort(self):
        self.versions.sort(key=lambda v: v["mt"], reverse=True)

    def add_version(self, fi: FileInfo):
        """Insert or replace the version with fi's version id."""
        d = fi.to_dict()
        d["vid"] = _normalize_vid(d["vid"]) or NULL_VERSION_ID
        self.versions = [v for v in self.versions if v["vid"] != d["vid"]]
        self.versions.append(d)
        self._sort()

    def delete_version(self, fi: FileInfo) -> str:
        """Remove a version and return its data dir, which the caller
        deletes. Raises ErrFileVersionNotFound when absent."""
        want = _normalize_vid(fi.version_id)
        for i, v in enumerate(self.versions):
            if v["vid"] == want:
                del self.versions[i]
                return v["dd"]
        raise ErrFileVersionNotFound(f"version {fi.version_id!r} not found")

    def find_version(self, version_id: str) -> dict:
        version_id = _normalize_vid(version_id)
        for v in self.versions:
            if v["vid"] == version_id:
                return v
        raise ErrFileVersionNotFound(f"version {version_id!r} not found")

    def latest(self) -> dict:
        if not self.versions:
            raise ErrFileVersionNotFound("no versions")
        return self.versions[0]

    def to_file_info(self, volume: str, name: str,
                     version_id: str | None) -> FileInfo:
        """The FileInfo of a version (None or "" = latest). The latest
        may be a delete marker (deleted=True); an explicit version that
        is missing raises."""
        v = self.find_version(version_id) if version_id else self.latest()
        fi = FileInfo.from_dict(v)
        fi.volume, fi.name = volume, name
        fi.is_latest = self.versions[0]["vid"] == v["vid"]
        fi.num_versions = len(self.versions)
        return fi


def read_xl_meta(buf: bytes, volume: str, name: str,
                 version_id: str | None) -> FileInfo:
    return XLMeta.from_bytes(buf).to_file_info(volume, name, version_id)

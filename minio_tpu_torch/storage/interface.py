"""StorageAPI: the per-disk storage interface the object layer calls,
the port's copy of minio_tpu/storage/interface.py (MinIO's StorageAPI,
cmd/storage-interface.go), cut to the calls the port's object layer
makes. A remote disk would plug in behind the same surface.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field

from .fileinfo import FileInfo


@dataclass
class VolInfo:
    name: str
    created_ns: int


@dataclass
class DiskInfo:
    """Subset of MinIO's DiskInfo (cmd/storage-datatypes.go)."""

    total: int = 0
    free: int = 0
    used: int = 0
    endpoint: str = ""
    mount_path: str = ""
    id: str = ""


@dataclass
class FileInfoVersions:
    """All versions of one object on one disk."""

    volume: str
    name: str
    versions: list[FileInfo] = field(default_factory=list)


class StorageAPI(abc.ABC):
    """Per-disk storage interface."""

    # --- identity ---

    @abc.abstractmethod
    def endpoint(self) -> str: ...

    @abc.abstractmethod
    def get_disk_id(self) -> str: ...

    @abc.abstractmethod
    def set_disk_id(self, disk_id: str) -> None: ...

    @abc.abstractmethod
    def disk_info(self) -> DiskInfo: ...

    @abc.abstractmethod
    def is_online(self) -> bool: ...

    # --- volumes ---

    @abc.abstractmethod
    def make_vol(self, volume: str) -> None: ...

    @abc.abstractmethod
    def list_vols(self) -> list[VolInfo]: ...

    @abc.abstractmethod
    def stat_vol(self, volume: str) -> VolInfo: ...

    @abc.abstractmethod
    def delete_vol(self, volume: str, force_delete: bool = False) -> None: ...

    # --- listing ---

    @abc.abstractmethod
    def list_dir(self, volume: str, dir_path: str,
                 count: int = -1) -> list[str]: ...

    @abc.abstractmethod
    def walk_dir(self, volume: str, base_dir: str = "",
                 recursive: bool = True, forward_to: str = ""):
        """Yield (object_path, xl.meta bytes) in lexical order."""

    # --- metadata ---

    @abc.abstractmethod
    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def read_version(self, volume: str, path: str, version_id: str = "",
                     read_data: bool = False) -> FileInfo: ...

    @abc.abstractmethod
    def update_metadata(self, volume: str, path: str,
                        fi: FileInfo) -> None:
        """Rewrite an existing version's journal entry with fi."""

    @abc.abstractmethod
    def list_versions(self, volume: str, path: str) -> FileInfoVersions: ...

    @abc.abstractmethod
    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def delete_versions(self, volume: str,
                        versions: list[FileInfo]) -> list:
        """Delete each version (fi.name is its object); the error of
        each, None where it went."""

    @abc.abstractmethod
    def rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                    dst_volume: str, dst_path: str) -> None: ...

    # --- files ---

    @abc.abstractmethod
    def rename_file(self, src_volume: str, src_path: str, dst_volume: str,
                    dst_path: str) -> None: ...

    @abc.abstractmethod
    def create_file_writer(self, volume: str, path: str, size: int = -1):
        """A writable sink for streamed shard writes; the caller closes
        it."""

    @abc.abstractmethod
    def read_file_stream(self, volume: str, path: str, offset: int,
                         length: int):
        """A readable (read / readinto) for [offset, offset+length) of a
        file; the caller closes it."""

    @abc.abstractmethod
    def read_repair_symbol(self, volume: str, path: str, *, stride: int,
                           digest_size: int, alpha: int, subs: list[int],
                           blocks: list[tuple[int, int]]) -> bytes:
        """The repair symbols (beta-slices) of a bitrot-framed shard file:
        for each (block index, chunk length) of `blocks`, the sub-shards
        `subs` of that block's chunk (chunk length / alpha bytes each),
        past the block's digest. `stride` is a full block's frame
        (digest + whole chunk); the last block's chunk may be shorter.
        Returns the slices block-major in `subs` order, exactly
        len(blocks) * len(subs) * chunk / alpha bytes, which is all the
        drive reads. No digest is checked: a slice cannot be without
        reading its whole chunk (the repair plane, erasure/repair.py)."""

    @abc.abstractmethod
    def check_parts(self, volume: str, path: str, fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def delete(self, volume: str, path: str,
               recursive: bool = False) -> None: ...

    # --- small blobs (WriteAll / ReadAll) ---

    @abc.abstractmethod
    def write_all(self, volume: str, path: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def read_all(self, volume: str, path: str) -> bytes: ...

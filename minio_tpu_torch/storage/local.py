"""LocalStorage: StorageAPI over one directory tree (a "drive"), the
port's copy of minio_tpu/storage/local.py (MinIO's xlStorage,
cmd/xl-storage.go), laying files out exactly as minio_tpu does:

    <root>/<volume>/<object...>/xl.meta          version journal
    <root>/<volume>/<object...>/<dataDir>/part.N shard data (bitrot-framed)
    <root>/.mtpu.sys/tmp/<uuid>/part.N           staged writes
    <root>/.mtpu.sys/format.json                 disk identity and format

Writes are staged under tmp and committed by an atomic rename
(`rename_data`); objects whose shard file is at most
`small_file_threshold()` keep their shard bytes inside xl.meta instead of
a part file. Everything here is host file I/O, except `verify_file`,
which checks every bitrot frame on the drive's device (kernel B on the
card).
"""

from __future__ import annotations

import io
import os
import shutil
import threading
import time

from ..erasure.bitrot import (
    BitrotAlgorithm,
    bitrot_shard_file_size,
    bitrot_verify,
)
from ..utils.device import resolve_device
from ..utils.errors import (
    ErrDiskNotFound,
    ErrFileAccessDenied,
    ErrFileCorrupt,
    ErrFileNotFound,
    ErrInvalidArgument,
    ErrVolumeExists,
    ErrVolumeNotEmpty,
    ErrVolumeNotFound,
    StorageError,
)
from .fileinfo import FileInfo
from .interface import DiskInfo, FileInfoVersions, StorageAPI, VolInfo
from .xlmeta import XLMeta

# Reserved system volume (MinIO's .minio.sys).
SYSTEM_META_BUCKET = ".mtpu.sys"
SYSTEM_TMP = SYSTEM_META_BUCKET + "/tmp"
XL_META_FILE = "xl.meta"

# Shard files at or below this size are inlined into xl.meta
# (smallFileThreshold): a small PUT is one metadata write per disk.
SMALL_FILE_THRESHOLD = 128 << 10


def small_file_threshold() -> int:
    """The inline threshold in bytes: MTPU_INLINE_THRESHOLD when set to
    an integer (0 turns inlining off), else SMALL_FILE_THRESHOLD. The
    same variable sets minio_tpu's, so one deployment setting holds for
    both packages."""
    env = os.environ.get("MTPU_INLINE_THRESHOLD", "")
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    return SMALL_FILE_THRESHOLD


def _check_path(p: str):
    if p.startswith("/") or ".." in p.split("/"):
        raise ErrInvalidArgument(f"unsafe path {p!r}")


class LocalStorage(StorageAPI):
    """POSIX StorageAPI over one directory tree. `device` is where
    verify_file hashes frames; it defaults to the card and raises at
    construction when there is none."""

    def __init__(self, root: str, endpoint: str = "", fsync: bool = False,
                 device="cuda"):
        self.root = os.path.abspath(root)
        self.device = resolve_device(device)
        self._endpoint = endpoint or self.root
        self._fsync = fsync
        self._disk_id = ""
        self._lock = threading.RLock()
        self._online = True
        os.makedirs(os.path.join(self.root, *SYSTEM_TMP.split("/")),
                    exist_ok=True)

    # --- helpers ---

    def _vol_path(self, volume: str) -> str:
        _check_path(volume)
        return os.path.join(self.root, volume)

    def _file_path(self, volume: str, path: str) -> str:
        _check_path(path)
        return os.path.join(self._vol_path(volume), *path.split("/"))

    def _require_online(self):
        if not self._online:
            raise ErrDiskNotFound(self._endpoint)

    def set_online(self, online: bool):
        """Fault injection: an offline disk raises ErrDiskNotFound."""
        self._online = online

    def is_online(self) -> bool:
        return self._online

    # --- identity ---

    def endpoint(self) -> str:
        return self._endpoint

    def get_disk_id(self) -> str:
        self._require_online()
        return self._disk_id

    def set_disk_id(self, disk_id: str) -> None:
        self._disk_id = disk_id

    def disk_info(self) -> DiskInfo:
        self._require_online()
        st = shutil.disk_usage(self.root)
        return DiskInfo(total=st.total, free=st.free, used=st.used,
                        endpoint=self._endpoint, mount_path=self.root,
                        id=self._disk_id)

    # --- volumes ---

    def make_vol(self, volume: str) -> None:
        self._require_online()
        p = self._vol_path(volume)
        if os.path.isdir(p):
            raise ErrVolumeExists(volume)
        os.makedirs(p, exist_ok=True)

    def list_vols(self) -> list[VolInfo]:
        self._require_online()
        out = []
        for name in sorted(os.listdir(self.root)):
            p = os.path.join(self.root, name)
            if os.path.isdir(p):
                out.append(VolInfo(name=name,
                                   created_ns=int(os.stat(p).st_ctime_ns)))
        return out

    def stat_vol(self, volume: str) -> VolInfo:
        self._require_online()
        p = self._vol_path(volume)
        if not os.path.isdir(p):
            raise ErrVolumeNotFound(volume)
        return VolInfo(name=volume, created_ns=int(os.stat(p).st_ctime_ns))

    def delete_vol(self, volume: str, force_delete: bool = False) -> None:
        self._require_online()
        p = self._vol_path(volume)
        if not os.path.isdir(p):
            raise ErrVolumeNotFound(volume)
        if force_delete:
            shutil.rmtree(p)
            return
        try:
            os.rmdir(p)
        except OSError as exc:
            raise ErrVolumeNotEmpty(volume) from exc

    def purge_stale_tmp(self) -> int:
        """Drop every staged write under <root>/.mtpu.sys/tmp: at boot no
        writer can still own one (formatErasureCleanupTmp). Returns the
        entries removed."""
        base = os.path.join(self._vol_path(SYSTEM_META_BUCKET), "tmp")
        if not os.path.isdir(base):
            return 0
        purged = 0
        for name in os.listdir(base):
            full = os.path.join(base, name)
            try:
                if os.path.isdir(full):
                    shutil.rmtree(full)
                else:
                    os.remove(full)
                purged += 1
            except OSError:
                continue  # raced cleanup: left for the next boot
        return purged

    # --- listing ---

    def list_dir(self, volume: str, dir_path: str,
                 count: int = -1) -> list[str]:
        """The sorted entries of a directory, directories with a
        trailing "/" (ListDir)."""
        self._require_online()
        p = (self._file_path(volume, dir_path) if dir_path
             else self._vol_path(volume))
        if not os.path.isdir(self._vol_path(volume)):
            raise ErrVolumeNotFound(volume)
        if not os.path.isdir(p):
            raise ErrFileNotFound(dir_path)
        entries = []
        for name in sorted(os.listdir(p)):
            full = os.path.join(p, name)
            entries.append(name + "/" if os.path.isdir(full) else name)
            if 0 < count <= len(entries):
                break
        return entries

    def walk_dir(self, volume: str, base_dir: str = "",
                 recursive: bool = True, forward_to: str = ""):
        """Yield (object_path, xl.meta bytes) in lexical order, the local
        producer behind listing (WalkDir, cmd/metacache-walk.go): a
        directory holding xl.meta is an object, any other is walked into
        (or, not recursive, yielded as "dir/" with no bytes). Entries
        before `forward_to` are skipped."""
        self._require_online()
        vol = self._vol_path(volume)
        if not os.path.isdir(vol):
            raise ErrVolumeNotFound(volume)

        def walk(rel: str):
            p = os.path.join(vol, *rel.split("/")) if rel else vol
            try:
                names = sorted(os.listdir(p))
            except FileNotFoundError:
                return
            if XL_META_FILE in names:
                with open(os.path.join(p, XL_META_FILE), "rb") as f:
                    yield rel, f.read()
                return
            for name in names:
                child = f"{rel}/{name}" if rel else name
                if os.path.isdir(os.path.join(p, name)):
                    if recursive:
                        yield from walk(child)
                    else:
                        yield child + "/", b""

        for item in walk(base_dir.strip("/")):
            if forward_to and item[0] < forward_to:
                continue
            yield item

    # --- metadata ---

    def _read_meta(self, volume: str, path: str) -> XLMeta:
        meta_path = os.path.join(self._file_path(volume, path), XL_META_FILE)
        try:
            with open(meta_path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            if not os.path.isdir(self._vol_path(volume)):
                raise ErrVolumeNotFound(volume) from None
            raise ErrFileNotFound(f"{volume}/{path}") from None
        return XLMeta.from_bytes(raw)

    def _write_meta(self, volume: str, path: str, meta: XLMeta):
        obj_dir = self._file_path(volume, path)
        os.makedirs(obj_dir, exist_ok=True)
        tmp = os.path.join(
            obj_dir, f".xl.meta.tmp.{os.getpid()}.{time.monotonic_ns()}")
        with open(tmp, "wb") as f:
            f.write(meta.to_bytes())
            if self._fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, os.path.join(obj_dir, XL_META_FILE))

    def _add_version(self, volume: str, path: str, fi: FileInfo) -> None:
        """Merge fi into the object's journal, creating it if absent."""
        try:
            meta = self._read_meta(volume, path)
        except ErrFileNotFound:
            meta = XLMeta()
        meta.add_version(fi)
        self._write_meta(volume, path, meta)

    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        self._require_online()
        with self._lock:
            self._add_version(volume, path, fi)

    def read_version(self, volume: str, path: str, version_id: str = "",
                     read_data: bool = False) -> FileInfo:
        self._require_online()
        fi = self._read_meta(volume, path).to_file_info(volume, path,
                                                        version_id)
        if not read_data:
            fi.data = {}
        return fi

    def update_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        self._require_online()
        with self._lock:
            meta = self._read_meta(volume, path)
            meta.find_version(fi.version_id)  # must exist
            meta.add_version(fi)
            self._write_meta(volume, path, meta)

    def list_versions(self, volume: str, path: str) -> FileInfoVersions:
        """Every version of the journal, newest first. As minio_tpu's, an
        entry with the null version id resolves through to_file_info's
        "" = latest, so the null version reads as a second copy of the
        latest one whenever it is not the latest itself."""
        self._require_online()
        meta = self._read_meta(volume, path)
        out = FileInfoVersions(volume=volume, name=path)
        for v in meta.versions:
            out.versions.append(meta.to_file_info(volume, path, v["vid"]))
        return out

    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None:
        """Remove one version; drop the object directory when the journal
        empties (DeleteVersion)."""
        self._require_online()
        with self._lock:
            meta = self._read_meta(volume, path)
            data_dir = meta.delete_version(fi)
            if data_dir:
                shutil.rmtree(
                    os.path.join(self._file_path(volume, path), data_dir),
                    ignore_errors=True)
            if meta.versions:
                self._write_meta(volume, path, meta)
            else:
                shutil.rmtree(self._file_path(volume, path),
                              ignore_errors=True)
                self._cleanup_empty_dirs(volume, path)

    def delete_versions(self, volume: str, versions: list[FileInfo]) -> list:
        errs = []
        for fi in versions:
            try:
                self.delete_version(volume, fi.name, fi)
                errs.append(None)
            except (StorageError, OSError) as exc:
                errs.append(exc)
        return errs

    def _cleanup_empty_dirs(self, volume: str, path: str):
        vol = self._vol_path(volume)
        cur = self._file_path(volume, path)
        while cur != vol and cur.startswith(vol):
            try:
                os.rmdir(cur)
            except FileNotFoundError:
                pass  # the object directory itself, already removed
            except OSError:
                break  # not empty: stop climbing
            cur = os.path.dirname(cur)

    def rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                    dst_volume: str, dst_path: str) -> None:
        """Atomic commit: move the staged data dir into place and journal
        the version (RenameData). The per-disk lock keeps the rename and
        the journal merge together."""
        self._require_online()
        with self._lock:
            if fi.data_dir:
                src_data = self._file_path(src_volume, src_path)
                if not os.path.isdir(src_data):
                    raise ErrFileNotFound(f"{src_volume}/{src_path}")
                dst_dir = self._file_path(dst_volume, dst_path)
                os.makedirs(dst_dir, exist_ok=True)
                dst_data = os.path.join(dst_dir, fi.data_dir)
                if os.path.isdir(dst_data):
                    shutil.rmtree(dst_data)
                os.replace(src_data, dst_data)
            self._add_version(dst_volume, dst_path, fi)

    # --- files ---

    def rename_file(self, src_volume: str, src_path: str, dst_volume: str,
                    dst_path: str) -> None:
        """Move one file into place (RenameFile): a multipart part's
        staged shard becomes part.N."""
        self._require_online()
        src = self._file_path(src_volume, src_path)
        dst = self._file_path(dst_volume, dst_path)
        if not os.path.exists(src):
            raise ErrFileNotFound(f"{src_volume}/{src_path}")
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.replace(src, dst)

    def create_file_writer(self, volume: str, path: str, size: int = -1):
        self._require_online()
        if not os.path.isdir(self._vol_path(volume)):
            raise ErrVolumeNotFound(volume)
        p = self._file_path(volume, path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        # Unbuffered: the bitrot writer hands over whole frames, and a
        # short raw write is retried by _FullWriter, never dropped.
        f = _FullWriter(open(p, "wb", buffering=0))
        return _FsyncOnClose(f) if self._fsync else f

    def read_file_stream(self, volume: str, path: str, offset: int,
                         length: int):
        self._require_online()
        try:
            f = open(self._file_path(volume, path), "rb")
        except FileNotFoundError:
            raise ErrFileNotFound(f"{volume}/{path}") from None
        except IsADirectoryError:
            raise ErrFileAccessDenied(f"{volume}/{path}") from None
        f.seek(offset)
        return _LimitedReader(f, length)

    def read_repair_symbol(self, volume: str, path: str, *, stride: int,
                           digest_size: int, alpha: int, subs: list[int],
                           blocks: list[tuple[int, int]]) -> bytes:
        """One open and a seek a slice (minio_tpu's LocalStorage
        override)."""
        self._require_online()
        out = bytearray()
        try:
            with open(self._file_path(volume, path), "rb") as f:
                for block, chunk_len in blocks:
                    if chunk_len % alpha:
                        raise ValueError(
                            f"repair chunk {chunk_len} not divisible by "
                            f"alpha {alpha}")
                    sub_len = chunk_len // alpha
                    base = block * stride + digest_size
                    for sub in subs:
                        f.seek(base + sub * sub_len)
                        buf = f.read(sub_len)
                        if len(buf) != sub_len:
                            raise ErrFileCorrupt(
                                f"short repair read {volume}/{path}")
                        out += buf
        except FileNotFoundError:
            raise ErrFileNotFound(f"{volume}/{path}") from None
        except IsADirectoryError:
            raise ErrFileAccessDenied(f"{volume}/{path}") from None
        return bytes(out)

    def _part_path(self, volume: str, path: str, fi: FileInfo,
                   number: int) -> str:
        return os.path.join(self._file_path(volume, path), fi.data_dir,
                            f"part.{number}")

    def check_parts(self, volume: str, path: str, fi: FileInfo) -> None:
        """Every part file exists at its framed size (CheckParts)."""
        self._require_online()
        for part in fi.parts:
            if part.number in fi.data:
                continue  # inline
            BitrotAlgorithm.from_string(
                fi.erasure.get_checksum_info(part.number).algorithm)
            want = bitrot_shard_file_size(
                fi.erasure.shard_file_size(part.size),
                fi.erasure.shard_size())
            try:
                st = os.stat(self._part_path(volume, path, fi, part.number))
            except FileNotFoundError:
                raise ErrFileNotFound(
                    f"{volume}/{path} part.{part.number}") from None
            if st.st_size != want:
                raise ErrFileCorrupt(
                    f"part.{part.number} size {st.st_size} != {want}")

    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None:
        """Deep bitrot scan of every part, inline ones included, on the
        drive's device (VerifyFile). Raises ErrFileCorrupt on a size or
        digest mismatch, ErrFileNotFound for a missing part."""
        self._require_online()
        shard_size = fi.erasure.shard_size()
        for part in fi.parts:
            BitrotAlgorithm.from_string(
                fi.erasure.get_checksum_info(part.number).algorithm)
            part_size = fi.erasure.shard_file_size(part.size)
            if part.number in fi.data:
                blob = fi.data[part.number]
                bitrot_verify(io.BytesIO(blob), len(blob), part_size,
                              shard_size, self.device)
                continue
            p = self._part_path(volume, path, fi, part.number)
            try:
                f = open(p, "rb")
            except FileNotFoundError:
                raise ErrFileNotFound(
                    f"{volume}/{path} part.{part.number}") from None
            with f:
                bitrot_verify(f, os.fstat(f.fileno()).st_size, part_size,
                              shard_size, self.device)

    def delete(self, volume: str, path: str, recursive: bool = False) -> None:
        self._require_online()
        p = self._file_path(volume, path)
        if not os.path.exists(p):
            if not os.path.isdir(self._vol_path(volume)):
                raise ErrVolumeNotFound(volume)
            raise ErrFileNotFound(f"{volume}/{path}")
        if os.path.isdir(p):
            if recursive:
                shutil.rmtree(p)
            else:
                try:
                    os.rmdir(p)
                except OSError as exc:
                    raise ErrVolumeNotEmpty(f"{volume}/{path}") from exc
        else:
            os.remove(p)

    # --- small blobs ---

    def write_all(self, volume: str, path: str, data: bytes) -> None:
        self._require_online()
        if not os.path.isdir(self._vol_path(volume)):
            raise ErrVolumeNotFound(volume)
        p = self._file_path(volume, path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + f".tmp.{os.getpid()}.{time.monotonic_ns()}"
        with open(tmp, "wb") as f:
            f.write(data)
            if self._fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, p)

    def read_all(self, volume: str, path: str) -> bytes:
        self._require_online()
        try:
            with open(self._file_path(volume, path), "rb") as f:
                return f.read()
        except FileNotFoundError:
            if not os.path.isdir(self._vol_path(volume)):
                raise ErrVolumeNotFound(volume) from None
            raise ErrFileNotFound(f"{volume}/{path}") from None


class _FullWriter:
    """Raw-fd writer that retries short writes until every byte lands or
    the OS raises: write() on an unbuffered file is one syscall and may
    return a short count, which would silently truncate a shard."""

    def __init__(self, f):
        self._f = f

    def write(self, b) -> int:
        mv = memoryview(b).cast("B")
        total = len(mv)
        n = self._f.write(mv) or 0
        while n < total:
            wrote = self._f.write(mv[n:])
            if not wrote:
                raise OSError(f"write stalled at {n}/{total} bytes")
            n += wrote
        return total

    def fileno(self):
        return self._f.fileno()

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class _FsyncOnClose:
    """Writer that fsyncs before close: the durability point before the
    rename commit, when the drive asks for fsync."""

    def __init__(self, f):
        self._f = f

    def write(self, b):
        return self._f.write(b)

    def fileno(self):
        return self._f.fileno()

    def close(self):
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()


class _LimitedReader:
    """Read at most `limit` bytes from a file, then EOF."""

    def __init__(self, f, limit: int):
        self._f = f
        self._left = limit

    def read(self, n: int = -1) -> bytes:
        if self._left <= 0:
            return b""
        if n is None or n < 0 or n > self._left:
            n = self._left
        buf = self._f.read(n)
        self._left -= len(buf)
        return buf

    def readinto(self, b) -> int:
        if self._left <= 0:
            return 0
        view = memoryview(b)
        if len(view) > self._left:
            view = view[: self._left]
        n = self._f.readinto(view) or 0
        self._left -= n
        return n

    def close(self):
        self._f.close()

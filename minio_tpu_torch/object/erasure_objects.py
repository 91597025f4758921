"""ErasureObjects: one erasure set, object operations over k+m disks with
quorum semantics. The port's copy of minio_tpu/object/erasure_objects.py
(MinIO's erasureObjects, cmd/erasure-object.go), cut to PutObject,
GetObject, DeleteObject(s) with delete markers, the metadata-only
update of a version (tags, a REPLACE self-copy), HealObject, the bucket
calls, the raw listing walk and (from object/multipart.py) the
multipart calls, on the port's erasure streams and kernels.

PUT: order the disks by the object's hash order, stage bitrot-framed
shards under .mtpu.sys/tmp (or in memory for an inline object), encode
(kernel A for parity, kernel B for the digests), then commit by rename
under write quorum. GET: agree on xl.meta by quorum, read k of n shards,
verify every frame (kernel B) and rebuild missing data shards (kernel A);
a shard that failed queues the object for heal. Heal: rebuild the shards
of the disks whose xl.meta or part files are missing or the wrong size,
and commit them the way a PUT does.

The fan-out over disks (metadata reads, commits, deletes) runs file I/O
in a thread pool; the streams, and with them every kernel launch and
device copy, run on the calling thread.
"""

from __future__ import annotations

import heapq
import io
import threading
import time
from contextlib import ExitStack, contextmanager

from ..erasure import registry, repair
from ..erasure.bitrot import (
    DIGEST_SIZE,
    BitrotAlgorithm,
    StreamingBitrotReader,
    StreamingBitrotWriter,
    bitrot_shard_file_size,
)
from ..erasure.codec import cached_erasure
from ..erasure.streaming import decode_stream, encode_stream, heal_stream
from ..storage.fileinfo import ChecksumInfo, ErasureInfo, FileInfo, new_uuid
from ..storage.diskcheck import ROBUST
from ..storage.local import SYSTEM_META_BUCKET, small_file_threshold
from ..utils import fanout as fanout_policy
from ..utils.device import resolve_device
from ..utils.errors import (
    OBJECT_OP_IGNORED_ERRS,
    ErrBadDigest,
    ErrBucketNotFound,
    ErrDiskNotFound,
    ErrDiskOpTimeout,
    ErrErasureReadQuorum,
    ErrFileNotFound,
    ErrFileVersionNotFound,
    ErrInvalidArgument,
    ErrLessData,
    ErrMethodNotAllowed,
    ErrObjectNotFound,
    ErrOperationTimedOut,
    ErrPreconditionFailed,
    ErrVersionNotFound,
    ErrVolumeExists,
    ErrVolumeNotFound,
    StorageError,
    reduce_read_quorum_errs,
    reduce_write_quorum_errs,
)
from ..utils.nslock import NamespaceLock
from .metadata import (
    IO_POOL,
    common_mod_time,
    fanout,
    find_file_info_in_quorum,
    hash_order,
    object_quorum_from_meta,
    read_all_file_info,
    shuffle_disks,
    shuffle_disks_and_parts_metadata,
)
from .multipart import MultipartMixin
from .types import ObjectInfo, ObjectOptions, TeeMD5Reader

BLOCK_SIZE_V2 = 1 << 20  # erasure block size of new objects (blockSizeV2)

_BITROT = BitrotAlgorithm.HIGHWAYHASH256S


_IO_COMPENSATOR = fanout_policy.StragglerCompensator(IO_POOL)


def _quorum_fanout(attempt, disks: list, errs: list, quorum: int) -> None:
    """The quorum-wait fan-out of the delete paths: attempt(i), which
    raises on failure, for every disk, errs[i] its error; returns once
    `quorum` succeeded and a straggler grace passed. A disk still in
    flight then is detached with ErrDiskOpTimeout (quorum-ignored, like
    an offline disk), and MRF heals what it missed. One core runs the
    attempts in turn."""
    n = len(disks)
    if fanout_policy.SINGLE_CORE:
        for i in range(n):
            try:
                attempt(i)
            except (StorageError, OSError) as exc:
                errs[i] = exc
        return
    pending = set(range(n))

    def record(i, err):
        if err is not None:
            errs[i] = err

    def on_detach(i):
        errs[i] = ErrDiskOpTimeout(f"disk {i} straggling past quorum")

    fanout_policy.QuorumFanout(IO_POOL, _IO_COMPENSATOR).dispatch(
        attempt, pending, (), quorum, ROBUST.op_deadline_s,
        ROBUST.straggler_grace_s,
        count_ok=lambda: sum(1 for j in range(n)
                             if errs[j] is None and j not in pending),
        record=record, on_detach=on_detach)


def _close_sinks(sinks) -> None:
    """Close every open sink or reader, whatever each raises."""
    for s in sinks.values() if isinstance(sinks, dict) else sinks:
        if s is not None:
            try:
                s.close()
            except OSError:
                pass


class ErasureObjects(MultipartMixin):
    """One erasure set of len(disks) shards. `device` runs the set's
    kernels; it defaults to the card and raises at construction when
    there is none."""

    # Bounded lock waits: a lock cycle becomes a retriable error, never a
    # wedged thread.
    NS_LOCK_TIMEOUT_S = 120.0

    def __init__(self, disks: list, default_parity: int | None = None,
                 set_index: int = 0, pool_index: int = 0, device="cuda"):
        if len(disks) < 2:
            raise ErrInvalidArgument("erasure set needs >= 2 disks")
        self.device = resolve_device(device)
        self.disks = list(disks)
        self.set_drive_count = len(disks)
        self.default_parity = (default_parity if default_parity is not None
                               else len(disks) // 2)
        self.set_index = set_index
        self.pool_index = pool_index
        # Objects a read or a partial write found in need of heal
        # (MinIO's MRF queue); drain_mrf hands them to a healer.
        self._mrf: list[tuple[str, str, str]] = []
        self._mrf_lock = threading.Lock()
        self._ns_lock = NamespaceLock()

    # ------------------------------------------------------------------
    # helpers

    @contextmanager
    def _locked(self, bucket: str, object_: str, writer: bool):
        lock = self._ns_lock.write if writer else self._ns_lock.read
        with ExitStack() as stack:
            try:
                stack.enter_context(lock(f"{bucket}/{object_}",
                                         timeout=self.NS_LOCK_TIMEOUT_S))
            except TimeoutError as exc:
                raise ErrOperationTimedOut(f"{bucket}/{object_}") from exc
            yield

    @staticmethod
    def _block_size() -> int:
        """The erasure block size of new objects."""
        return BLOCK_SIZE_V2

    def _object_erasure(self, k: int, m: int, block_size: int,
                        codec: str = ""):
        """The set's shared Erasure for a geometry; "" is the dense codec
        of metadata from before codec ids."""
        return cached_erasure(k, m, block_size,
                              codec or registry.DEFAULT_CODEC, self.device)

    @staticmethod
    def _tmp_path(tmp_id: str) -> str:
        return f"tmp/{tmp_id}"

    def _cleanup_tmp(self, disks: list, tmp_id: str) -> None:
        for disk in disks:
            if disk is None:
                continue
            try:
                disk.delete(SYSTEM_META_BUCKET, self._tmp_path(tmp_id),
                            recursive=True)
            except (StorageError, OSError):
                pass  # nothing staged there, or the disk is gone

    def queue_mrf(self, bucket: str, object_: str, version_id: str = ""):
        with self._mrf_lock:
            self._mrf.append((bucket, object_, version_id))

    def drain_mrf(self) -> list[tuple[str, str, str]]:
        with self._mrf_lock:
            out, self._mrf = self._mrf, []
        return out

    def _on_every_disk(self, op, disks: list | None = None) -> list:
        """Run op(i, disk) for every disk (the set's, or `disks` in shard
        order) in parallel; the error of each (ErrDiskNotFound for a
        missing disk), None where it succeeded."""
        disks = self.disks if disks is None else disks
        errs: list = [None] * len(disks)

        def do(i):
            try:
                if disks[i] is None:
                    raise ErrDiskNotFound(f"disk {i}")
                op(i, disks[i])
            except (StorageError, OSError) as exc:
                errs[i] = exc

        fanout(do, len(disks))
        return errs

    def _disk_quorum_fanout(self, op, ignore: type) -> None:
        """Run op(disk) on every disk, an error of class `ignore` counting
        as success, and raise the write-quorum error, if any, of the
        rest (majority quorum, as bucket operations use)."""
        errs = [None if isinstance(e, ignore) else e
                for e in self._on_every_disk(lambda _, d: op(d))]
        err = reduce_write_quorum_errs(errs, OBJECT_OP_IGNORED_ERRS,
                                       len(self.disks) // 2 + 1)
        if err is not None:
            raise err

    # ------------------------------------------------------------------
    # buckets (cmd/erasure-bucket.go)

    def make_bucket(self, bucket: str) -> None:
        self._disk_quorum_fanout(lambda d: d.make_vol(bucket),
                                 ErrVolumeExists)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        self._disk_quorum_fanout(
            lambda d: d.delete_vol(bucket, force_delete=force),
            ErrVolumeNotFound)

    def bucket_exists(self, bucket: str) -> bool:
        ok = 0
        for d in self.disks:
            if d is None:
                continue
            try:
                d.stat_vol(bucket)
                ok += 1
            except (StorageError, OSError):
                continue
        return ok >= len(self.disks) // 2

    def heal_bucket(self, bucket: str) -> dict:
        """Make the bucket's volume on the disks that lack it
        (healBucket, cmd/erasure-healing.go:57)."""
        healed = []
        for disk in self.disks:
            if disk is None:
                continue
            try:
                disk.stat_vol(bucket)
            except ErrVolumeNotFound:
                try:
                    disk.make_vol(bucket)
                    healed.append(disk.endpoint())
                except (StorageError, OSError):
                    continue
            except (StorageError, OSError):
                continue
        return {"healed": healed}

    # ------------------------------------------------------------------
    # listing (listPathRaw, cmd/metacache-set.go:816-973)

    def list_objects_raw(self, bucket: str, prefix: str = ""):
        """The sorted, de-duplicated stream of (name, xl.meta bytes) over
        the set's disks: a k-way merge of each disk's sorted walk, which
        starts at the prefix's deepest directory, so a listing costs the
        entries it consumes, not the bucket's size."""
        base_dir = prefix.rsplit("/", 1)[0] if "/" in prefix else ""

        def disk_stream(disk):
            try:
                for name, meta in disk.walk_dir(bucket, base_dir=base_dir,
                                                forward_to=prefix):
                    if prefix and not name.startswith(prefix):
                        if name > prefix:
                            return  # sorted: nothing later matches
                        continue
                    yield name, meta
            except (StorageError, OSError):
                return  # an offline disk drops out of the merge

        streams = [disk_stream(d) for d in self.disks if d is not None]
        last = None
        for name, meta in heapq.merge(*streams, key=lambda t: t[0]):
            if name == last:
                continue
            last = name
            yield name, meta

    # ------------------------------------------------------------------
    # put (putObject, cmd/erasure-object.go)

    def put_object(self, bucket: str, object_: str, reader, size: int,
                   opts: ObjectOptions | None = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        if opts.no_lock:
            return self._put_object(bucket, object_, reader, size, opts)
        # One writer of an object at a time, so commits of two PUTs never
        # interleave across disks.
        with self._locked(bucket, object_, writer=True):
            return self._put_object(bucket, object_, reader, size, opts)

    def _put_object(self, bucket: str, object_: str, reader, size: int,
                    opts: ObjectOptions) -> ObjectInfo:
        n = self.set_drive_count
        parity = self.default_parity
        if opts.parity is not None:
            if not 0 < opts.parity <= n // 2:
                raise ErrInvalidArgument(
                    f"parity {opts.parity} invalid for {n} drives")
            parity = opts.parity
        data_blocks = n - parity
        write_quorum = data_blocks + (1 if data_blocks == parity else 0)
        # Codec identity is fixed at PUT time and persisted in xl.meta:
        # the request's codec > MTPU_CODEC > auto-selection.
        codec_id = registry.select_codec(data_blocks, parity,
                                         forced=opts.codec,
                                         device=self.device)
        wire_algo = registry.get(codec_id).wire_algorithm
        block_size = self._block_size()
        erasure = self._object_erasure(data_blocks, parity, block_size,
                                       codec_id)
        distribution = hash_order(f"{bucket}/{object_}", n)
        disks_by_shard = shuffle_disks(self.disks, distribution)

        shard_file_size = erasure.shard_file_size(size) if size >= 0 else -1
        inline = 0 <= shard_file_size <= small_file_threshold()
        tmp_id = new_uuid()
        data_dir = new_uuid()
        tee = TeeMD5Reader(reader, size=size)
        phys_shard = (bitrot_shard_file_size(shard_file_size,
                                             erasure.shard_size())
                      if shard_file_size >= 0 else -1)

        writers: list = [None] * n
        sinks: list = [None] * n
        for i, disk in enumerate(disks_by_shard):
            if disk is None:
                continue
            try:
                sinks[i] = io.BytesIO() if inline else disk.create_file_writer(
                    SYSTEM_META_BUCKET, f"{self._tmp_path(tmp_id)}/part.1",
                    size=phys_shard)
            except (StorageError, OSError):
                continue  # offline at open time: its shard heals later
            writers[i] = StreamingBitrotWriter(sinks[i], device=self.device)

        def abort():
            _close_sinks(sinks)
            if not inline:  # inline PUTs stage nothing on disk
                self._cleanup_tmp(disks_by_shard, tmp_id)

        try:
            total = encode_stream(erasure, tee, writers, write_quorum)
        except BaseException:
            abort()
            raise
        if size >= 0 and total != size:
            abort()
            raise ErrLessData(f"read {total} bytes, expected {size}")
        size = total
        if not inline:
            for i, s in enumerate(sinks):
                if s is None:
                    continue
                try:
                    s.close()
                except OSError:
                    writers[i] = None  # not durable: this disk misses it

        mod_time_ns = opts.mod_time_ns or time.time_ns()
        version_id = opts.version_id or (new_uuid() if opts.versioned else "")
        etag = tee.md5_hex()
        if opts.want_md5_hex and etag != opts.want_md5_hex:
            # Checked before the commit: a bad digest leaves nothing.
            if not inline:
                self._cleanup_tmp(disks_by_shard, tmp_id)
            raise ErrBadDigest(
                f"content md5 {etag} != declared {opts.want_md5_hex}")
        metadata = dict(opts.user_defined)
        metadata["etag"] = etag
        metadata.setdefault("content-type", "application/octet-stream")

        def erasure_info(index: int) -> ErasureInfo:
            return ErasureInfo(
                algorithm=wire_algo, data_blocks=data_blocks,
                parity_blocks=parity, block_size=block_size, index=index,
                distribution=list(distribution),
                checksums=[ChecksumInfo(1, _BITROT.value)] if index else [],
                codec=codec_id)

        errs: list = [None] * n

        def commit(i):
            disk = disks_by_shard[i]
            try:
                if disk is None or writers[i] is None:
                    raise ErrDiskNotFound(f"disk {i}")
                fi = FileInfo(volume=bucket, name=object_,
                              version_id=version_id,
                              data_dir="" if inline else data_dir,
                              mod_time_ns=mod_time_ns, size=size,
                              metadata=dict(metadata),
                              erasure=erasure_info(i + 1))
                fi.add_part(1, size, size)
                if inline:
                    # The shard bytes ride inside xl.meta: one journal
                    # write, no staged file, no rename.
                    fi.data = {1: sinks[i].getvalue()}
                    disk.write_metadata(bucket, object_, fi)
                else:
                    disk.rename_data(SYSTEM_META_BUCKET,
                                     self._tmp_path(tmp_id), fi, bucket,
                                     object_)
            except (StorageError, OSError) as exc:
                errs[i] = exc

        fanout(commit, n)
        err = reduce_write_quorum_errs(errs, OBJECT_OP_IGNORED_ERRS,
                                       write_quorum)
        if err is not None:
            # Undo the commits that landed: a sub-quorum PUT must leave
            # no readable version on the minority (undoRename).
            undo = FileInfo(volume=bucket, name=object_,
                            version_id=version_id)
            for i, e in enumerate(errs):
                if e is None and disks_by_shard[i] is not None:
                    try:
                        disks_by_shard[i].delete_version(bucket, object_,
                                                         undo)
                    except (StorageError, OSError):
                        pass
            if not inline:
                self._cleanup_tmp(disks_by_shard, tmp_id)
            raise err
        if any(e is not None for e in errs):
            self.queue_mrf(bucket, object_, version_id)  # partial write

        fi = FileInfo(volume=bucket, name=object_, version_id=version_id,
                      mod_time_ns=mod_time_ns, size=size, metadata=metadata,
                      erasure=erasure_info(0), num_versions=1)
        return ObjectInfo.from_file_info(fi, bucket, object_, opts.versioned)

    # ------------------------------------------------------------------
    # get (getObjectWithFileInfo, cmd/erasure-object.go)

    def _read_quorum_file_info(self, bucket: str, object_: str,
                               version_id: str, read_data: bool = False):
        fis, errs = read_all_file_info(self.disks, bucket, object_,
                                       version_id, read_data)
        if all(fi is None for fi in fis):
            err = reduce_read_quorum_errs(errs, OBJECT_OP_IGNORED_ERRS, 1)
            raise self._to_object_err(err, bucket, object_, version_id)
        try:
            read_quorum, _ = object_quorum_from_meta(fis, errs,
                                                     self.default_parity)
        except ErrErasureReadQuorum:
            raise self._to_object_err(ErrErasureReadQuorum(), bucket,
                                      object_, version_id) from None
        err = reduce_read_quorum_errs(errs, OBJECT_OP_IGNORED_ERRS,
                                      read_quorum)
        if err is not None:
            raise self._to_object_err(err, bucket, object_, version_id)
        mt, dd = common_mod_time(fis)
        fi = find_file_info_in_quorum(fis, mt, dd, read_quorum)
        return fi, fis, errs

    @staticmethod
    def _to_object_err(err, bucket, object_, version_id=""):
        if isinstance(err, ErrFileNotFound):
            return ErrObjectNotFound(f"{bucket}/{object_}")
        if isinstance(err, ErrFileVersionNotFound):
            return ErrVersionNotFound(f"{bucket}/{object_} ({version_id})")
        if isinstance(err, ErrVolumeNotFound):
            return ErrBucketNotFound(bucket)
        return err if err is not None else ErrErasureReadQuorum()

    @staticmethod
    def _refuse_delete_marker(fi: FileInfo, bucket: str, object_: str,
                              opts: ObjectOptions) -> None:
        if fi.deleted:
            if not opts.version_id:
                raise ErrObjectNotFound(f"{bucket}/{object_}")
            raise ErrMethodNotAllowed("delete marker")

    def get_object_info(self, bucket: str, object_: str,
                        opts: ObjectOptions | None = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        fi, _, _ = self._read_quorum_file_info(bucket, object_,
                                               opts.version_id)
        self._refuse_delete_marker(fi, bucket, object_, opts)
        return ObjectInfo.from_file_info(
            fi, bucket, object_, opts.versioned or bool(opts.version_id))

    def get_object(self, bucket: str, object_: str, writer,
                   offset: int = 0, length: int = -1,
                   opts: ObjectOptions | None = None) -> ObjectInfo:
        """Write bytes [offset, offset+length) of the object (length -1:
        to its end) to `writer`."""
        opts = opts or ObjectOptions()
        if opts.no_lock:
            return self._get_object(bucket, object_, writer, offset,
                                    length, opts)
        # A concurrent PUT or heal must not swap data dirs mid-stream.
        with self._locked(bucket, object_, writer=False):
            return self._get_object(bucket, object_, writer, offset,
                                    length, opts)

    def _get_object(self, bucket: str, object_: str, writer, offset: int,
                    length: int, opts: ObjectOptions) -> ObjectInfo:
        fi, fis, _ = self._read_quorum_file_info(
            bucket, object_, opts.version_id, read_data=True)
        self._refuse_delete_marker(fi, bucket, object_, opts)
        if (opts.expected_etag
                and fi.metadata.get("etag", "") != opts.expected_etag):
            # Replaced since the caller sent its headers: no byte of
            # another object goes out under the advertised ETag.
            raise ErrPreconditionFailed(f"{bucket}/{object_}: etag changed")
        if length == -1:
            length = fi.size - offset
        if offset < 0 or length < 0 or offset + length > fi.size:
            raise ErrInvalidArgument("invalid range")
        oi = ObjectInfo.from_file_info(fi, bucket, object_, opts.versioned)
        if length == 0 or not fi.parts:
            return oi
        erasure = self._object_erasure(
            fi.erasure.data_blocks, fi.erasure.parity_blocks,
            fi.erasure.block_size, fi.erasure.codec)
        heal_hint = self._decode_range(bucket, object_, fi, fis, erasure,
                                       writer, offset, length)
        if heal_hint is not None:
            self.queue_mrf(bucket, object_, fi.version_id)
        return oi

    def _decode_range(self, bucket: str, object_: str, fi: FileInfo,
                      fis: list, erasure, writer, offset: int,
                      length: int):
        """Decode object bytes [offset, offset+length) part by part;
        returns the first heal hint a part's stream gave, if any."""
        disks_by_shard, metas_by_shard = shuffle_disks_and_parts_metadata(
            self.disks, fis, fi)
        part_index, part_offset = fi.to_object_part_index(offset)
        remaining = length
        heal_hint = None
        for part in fi.parts[part_index:]:
            if remaining <= 0:
                break
            part_length = min(part.size - part_offset, remaining)
            till_offset = erasure.shard_file_offset(part_offset, part_length,
                                                    part.size)
            readers = [
                None if disk is None or meta is None else self._shard_reader(
                    disk, meta, bucket, object_, fi, part.number,
                    till_offset, erasure.shard_size())
                for disk, meta in zip(disks_by_shard, metas_by_shard)]
            try:
                _, hint = decode_stream(erasure, writer, readers,
                                        part_offset, part_length, part.size)
            finally:
                _close_sinks(readers)
            if hint is not None and heal_hint is None:
                heal_hint = hint
            remaining -= part_length
            part_offset = 0
        return heal_hint

    def _shard_reader(self, disk, meta: FileInfo, bucket: str, object_: str,
                      fi: FileInfo, part_number: int, till_offset: int,
                      shard_size: int) -> StreamingBitrotReader:
        BitrotAlgorithm.from_string(
            meta.erasure.get_checksum_info(part_number).algorithm)
        inline = meta.data.get(part_number)
        if inline is not None:
            def open_stream(off, ln, buf=inline):
                return io.BytesIO(buf[off: off + ln])
        else:
            path = f"{object_}/{fi.data_dir}/part.{part_number}"

            def open_stream(off, ln, d=disk, p=path):
                return d.read_file_stream(bucket, p, off, ln)
        r = StreamingBitrotReader(open_stream, till_offset, shard_size,
                                  device=self.device)
        r.local = True  # an inline buffer or a LocalStorage drive
        return r

    @staticmethod
    def _repair_sources(avail_by_shard: list, bucket: str, object_: str,
                        fi: FileInfo, part_number: int) -> list:
        """The repair plane's SymbolSource of each surviving shard: its
        drive and the part file's frame geometry. Every part the port
        reads is framed by HighwayHash256S (check_parts refuses other
        algorithms), whose digests interleave the chunks."""
        path = f"{object_}/{fi.data_dir}/part.{part_number}"
        return [None if disk is None else repair.SymbolSource(
                    disk=disk, volume=bucket, path=path,
                    digest_size=DIGEST_SIZE)
                for disk in avail_by_shard]

    # ------------------------------------------------------------------
    # delete (DeleteObject, cmd/erasure-object.go)

    def delete_object(self, bucket: str, object_: str,
                      opts: ObjectOptions | None = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        if opts.no_lock:
            return self._delete_object(bucket, object_, opts)
        with self._locked(bucket, object_, writer=True):
            return self._delete_object(bucket, object_, opts)

    def _delete_object(self, bucket: str, object_: str,
                       opts: ObjectOptions) -> ObjectInfo:
        n = self.set_drive_count
        write_quorum = n // 2 + 1

        def on_disk(op):
            def attempt(i):
                if self.disks[i] is None:
                    raise ErrDiskNotFound(f"disk {i}")
                op(self.disks[i])
            return attempt

        if opts.versioned and not opts.version_id:
            # A versioned delete without a version writes a delete marker.
            marker = FileInfo(volume=bucket, name=object_,
                              version_id=new_uuid(), deleted=True,
                              mod_time_ns=opts.mod_time_ns or time.time_ns())
            errs: list = [None] * n
            _quorum_fanout(on_disk(lambda d: d.write_metadata(
                bucket, object_, marker)), self.disks, errs, write_quorum)
            err = reduce_write_quorum_errs(errs, OBJECT_OP_IGNORED_ERRS,
                                           write_quorum)
            if err is not None:
                raise err
            if any(e is not None for e in errs):
                # The marker's own version id: heal replicates that exact
                # version, even after a newer write lands.
                self.queue_mrf(bucket, object_, marker.version_id)
            return ObjectInfo(bucket=bucket, name=object_,
                              version_id=marker.version_id,
                              delete_marker=True)

        # A targeted delete, or an untargeted one on an unversioned or
        # suspended bucket: the version is removed (under suspension the
        # null version, "").
        fi = FileInfo(volume=bucket, name=object_,
                      version_id=opts.version_id)
        errs = [None] * n
        _quorum_fanout(on_disk(lambda d: d.delete_version(bucket, object_,
                                                          fi)),
                       self.disks, errs, write_quorum)
        err = reduce_write_quorum_errs(errs, OBJECT_OP_IGNORED_ERRS,
                                       write_quorum)
        if err is not None:
            raise self._to_object_err(err, bucket, object_, opts.version_id)
        if any(not isinstance(e, (type(None), ErrFileNotFound,
                                  ErrFileVersionNotFound)) for e in errs):
            # A disk that missed the delete still holds the version.
            self.queue_mrf(bucket, object_, opts.version_id)
        return ObjectInfo(bucket=bucket, name=object_,
                          version_id=opts.version_id)

    def delete_objects(self, bucket: str, objects: list[str],
                       opts: ObjectOptions | None = None) -> list:
        """DeleteObject of each name with the same options: the error of
        each, None where it went."""
        out = []
        for o in objects:
            try:
                self.delete_object(bucket, o, opts)
                out.append(None)
            except StorageError as exc:
                out.append(exc)
        return out

    # ------------------------------------------------------------------
    # metadata-only updates (updateObjectMeta)

    def update_object_metadata(self, bucket: str, object_: str,
                               version_id: str, updates: dict,
                               replace_user_meta: bool = False
                               ) -> int | None:
        """Merge `updates` into a version's metadata on every online disk;
        `replace_user_meta` first drops its x-amz-meta-* keys and stamps
        a new mod time (a REPLACE self-copy). No shard byte moves. Returns
        the new mod time in ns, or None when it was left as it was."""
        # The read-modify-write of every disk's xl.meta must not
        # interleave with a PUT or heal of the object.
        with self._locked(bucket, object_, writer=True):
            return self._update_object_metadata(bucket, object_, version_id,
                                                updates, replace_user_meta)

    def _update_object_metadata(self, bucket: str, object_: str,
                                version_id: str, updates: dict,
                                replace_user_meta: bool) -> int | None:
        # With its inline data: rewriting an inline version without it
        # would lose the object.
        fi, fis, _ = self._read_quorum_file_info(bucket, object_, version_id,
                                                 read_data=True)
        if replace_user_meta:
            new_meta = {k: v for k, v in fi.metadata.items()
                        if not k.startswith("x-amz-meta-")}
        else:
            new_meta = dict(fi.metadata)
        new_meta.update(updates)
        new_mod_time = time.time_ns() if replace_user_meta else None

        def do(i):
            disk, meta = self.disks[i], fis[i]
            if disk is None or meta is None:
                return
            m = FileInfo.from_dict(meta.to_dict())
            m.volume, m.name = bucket, object_
            m.metadata = dict(new_meta)
            if new_mod_time is not None:
                m.mod_time_ns = new_mod_time
            try:
                disk.update_metadata(bucket, object_, m)
            except (StorageError, OSError):
                pass  # best effort a disk; heal brings it in line

        fanout(do, len(self.disks))
        return new_mod_time

    # ------------------------------------------------------------------
    # heal (healObject, cmd/erasure-healing.go)

    def heal_object(self, bucket: str, object_: str, version_id: str = "",
                    remove_dangling: bool = False) -> dict:
        """Rebuild the shards of the disks whose copy of the version is
        missing, stale or the wrong size. Returns {"healed": [endpoints
        rewritten], "dangling": whether too few shards were left}."""
        # Heal rewrites shards and metadata: no PUT or delete meanwhile.
        with self._locked(bucket, object_, writer=True):
            return self._heal_object(bucket, object_, version_id,
                                     remove_dangling)

    def _heal_object(self, bucket: str, object_: str, version_id: str,
                     remove_dangling: bool) -> dict:
        fis, errs = read_all_file_info(self.disks, bucket, object_,
                                       version_id, read_data=True)
        valid = [fi for fi in fis if fi is not None]
        if not valid:
            raise self._to_object_err(
                reduce_read_quorum_errs(errs, OBJECT_OP_IGNORED_ERRS, 1),
                bucket, object_, version_id)
        mt, dd = common_mod_time(fis)
        ref_fi = next(fi for fi in valid
                      if fi.mod_time_ns == mt and fi.data_dir == dd)
        data_blocks = ref_fi.erasure.data_blocks

        # A disk is available when its version agrees and its part files
        # exist at their framed size (disksWithAllParts); a flipped byte
        # is found by GET and verify_file, not here.
        available = [False] * len(self.disks)
        for i, fi in enumerate(fis):
            if fi is None or self.disks[i] is None:
                continue
            if (fi.mod_time_ns != mt or fi.data_dir != dd
                    or fi.deleted != ref_fi.deleted):
                continue
            try:
                if not fi.deleted:
                    self.disks[i].check_parts(bucket, object_, fi)
            except (StorageError, ValueError, OSError):
                continue
            available[i] = True

        n_avail = sum(available)
        if n_avail < data_blocks and not ref_fi.deleted:
            if remove_dangling:
                try:
                    self.delete_object(bucket, object_, ObjectOptions(
                        version_id=version_id, no_lock=True))
                except (ErrObjectNotFound, ErrVersionNotFound):
                    pass
                return {"healed": [], "dangling": True}
            raise ErrErasureReadQuorum(
                f"only {n_avail} of {data_blocks} shards available")

        stale = [i for i, ok in enumerate(available)
                 if not ok and self.disks[i] is not None]
        if not stale:
            return {"healed": [], "dangling": False}

        distribution = ref_fi.erasure.distribution
        disks_by_shard = shuffle_disks(self.disks, distribution)
        avail_by_shard = shuffle_disks(
            [d if ok else None for d, ok in zip(self.disks, available)],
            distribution)
        metas_by_shard = shuffle_disks(
            [fi if ok else None for fi, ok in zip(fis, available)],
            distribution)
        stale_shards = [s for s in range(len(disks_by_shard))
                        if avail_by_shard[s] is None
                        and disks_by_shard[s] is not None]

        tmp_id = new_uuid()
        inline = bool(ref_fi.data)
        healed_inline: dict[int, dict[int, bytes]] = {s: {}
                                                      for s in stale_shards}
        if not ref_fi.deleted:
            # Rebuild with the codec and block size the object was
            # written with.
            erasure = self._object_erasure(
                data_blocks, ref_fi.erasure.parity_blocks,
                ref_fi.erasure.block_size, ref_fi.erasure.codec)
            # The repair plane (erasure/repair.py) serves ONE stale shard
            # of a part file when every other shard survives (the plan
            # needs all n-1 helpers) and the codec has a plan for it:
            # each survivor reads only its beta-slices. Anything else
            # takes the dense heal_stream, the same bytes either way.
            use_repair = (
                not inline
                and len(stale_shards) == 1
                and repair.enabled()
                and all(avail_by_shard[s] is not None
                        for s in range(len(disks_by_shard))
                        if s != stale_shards[0])
                and repair.plan_for(erasure, stale_shards[0]) is not None)
            for part in ref_fi.parts:
                phys_shard = bitrot_shard_file_size(
                    erasure.shard_file_size(part.size), erasure.shard_size())

                def open_sinks(part=part, phys_shard=phys_shard):
                    ws: list = [None] * len(disks_by_shard)
                    for s in stale_shards:
                        sinks[s] = io.BytesIO() if inline else \
                            disks_by_shard[s].create_file_writer(
                                SYSTEM_META_BUCKET,
                                f"{self._tmp_path(tmp_id)}/part.{part.number}",
                                size=phys_shard)
                        ws[s] = StreamingBitrotWriter(sinks[s],
                                                      device=self.device)
                    return ws

                sinks: dict[int, object] = {}
                repaired = False
                if use_repair and part.size > 0:
                    try:
                        sources = self._repair_sources(
                            avail_by_shard, bucket, object_, ref_fi,
                            part.number)
                        writers = open_sinks()
                        repair.repair_part(erasure, stale_shards[0], sources,
                                           writers[stale_shards[0]],
                                           part.size)
                        repaired = True
                    except (repair.RepairUnavailable, StorageError,
                            OSError) as exc:
                        # A CUDA error is not caught: the dense path
                        # would run the same kernel. The dense heal
                        # re-creates (truncates) the same tmp files.
                        repair.note_fallback(getattr(exc, "reason",
                                                     "drive_error"))
                        _close_sinks(sinks)
                        sinks = {}
                    except BaseException:
                        _close_sinks(sinks)
                        self._cleanup_tmp(disks_by_shard, tmp_id)
                        raise
                if not repaired:
                    till = erasure.shard_file_offset(0, part.size, part.size)
                    readers = [
                        None if avail_by_shard[s] is None
                        else self._shard_reader(
                            avail_by_shard[s], metas_by_shard[s], bucket,
                            object_, ref_fi, part.number, till,
                            erasure.shard_size())
                        for s in range(len(disks_by_shard))]
                    try:
                        heal_stream(erasure, open_sinks(), readers,
                                    part.size)
                    except BaseException:
                        _close_sinks(sinks)
                        if not inline:
                            self._cleanup_tmp(disks_by_shard, tmp_id)
                        raise
                    finally:
                        _close_sinks(readers)
                for s in stale_shards:
                    if inline:
                        healed_inline[s][part.number] = sinks[s].getvalue()
                    else:
                        sinks[s].close()

        # Commit the rebuilt shards and metadata on the stale disks.
        healed = []
        for s in stale_shards:
            disk = disks_by_shard[s]
            fi = FileInfo.from_dict(ref_fi.to_dict())
            fi.volume, fi.name = bucket, object_
            fi.erasure.index = s + 1
            fi.data = healed_inline[s] if inline else {}
            try:
                if inline or ref_fi.deleted:
                    disk.write_metadata(bucket, object_, fi)
                else:
                    disk.rename_data(SYSTEM_META_BUCKET,
                                     self._tmp_path(tmp_id), fi, bucket,
                                     object_)
            except (StorageError, OSError):
                continue  # best effort per disk; the next heal retries
            healed.append(disk.endpoint())
        return {"healed": healed, "dangling": False}

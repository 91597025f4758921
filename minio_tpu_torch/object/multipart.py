"""Multipart uploads of an erasure set, the port's copy of the
MultipartMixin of minio_tpu/object/multipart.py (MinIO's
cmd/erasure-multipart.go).

An upload is journaled in an xl.meta under
.mtpu.sys/multipart/<sha256(bucket/object)>/<uploadID>/ on every disk of
the set. Each part is one `encode_stream` (kernel A for the parity,
kernel B for the digests) into part.N shard files staged beside the
journal; CompleteMultipartUpload renames the upload directory into the
object's data directory and stamps the S3 ETag of the parts.
"""

from __future__ import annotations

import hashlib
import time

from ..erasure import registry
from ..erasure.bitrot import (
    BitrotAlgorithm,
    StreamingBitrotWriter,
    bitrot_shard_file_size,
)
from ..erasure.streaming import encode_stream
from ..observability import ioflow
from ..storage.fileinfo import ChecksumInfo, ErasureInfo, FileInfo, new_uuid
from ..storage.local import SYSTEM_META_BUCKET
from ..storage.xlmeta import XLMeta
from ..utils import fanout
from ..utils.errors import (
    OBJECT_OP_IGNORED_ERRS,
    ErrBadDigest,
    ErrDiskNotFound,
    ErrErasureWriteQuorum,
    ErrInvalidArgument,
    ErrInvalidPart,
    ErrInvalidUploadID,
    ErrLessData,
    StorageError,
    reduce_read_quorum_errs,
    reduce_write_quorum_errs,
)
from .metadata import (
    common_mod_time,
    find_file_info_in_quorum,
    hash_order,
    read_all_file_info,
    shuffle_disks,
)
from .types import (
    CompletePart,
    MultipartInfo,
    ObjectInfo,
    ObjectOptions,
    PartInfo,
    TeeMD5Reader,
    compute_parts_etag,
)

# Part number ceiling (globalMaxPartID, cmd/utils.go).
MAX_PART_ID = 10000

_HIGHWAYHASH = BitrotAlgorithm.HIGHWAYHASH256S.value


def _upload_root(bucket: str, object_: str) -> str:
    sha = hashlib.sha256(f"{bucket}/{object_}".encode()).hexdigest()
    return f"multipart/{sha}"


def _part_etag_key(part_number: int) -> str:
    return f"x-mtpu-internal-part-etag-{part_number}"


class MultipartMixin:
    """The multipart calls of ErasureObjects (whose _on_every_disk,
    _locked, _object_erasure, _block_size and queue_mrf they use)."""

    def new_multipart_upload(self, bucket: str, object_: str,
                             opts: ObjectOptions | None = None) -> str:
        opts = opts or ObjectOptions()
        n = self.set_drive_count
        parity = self.default_parity
        if opts.parity is not None:
            if not 0 < opts.parity <= n // 2:
                raise ErrInvalidArgument(
                    f"parity {opts.parity} invalid for {n} drives")
            parity = opts.parity
        data_blocks = n - parity
        write_quorum = data_blocks + (1 if data_blocks == parity else 0)
        upload_id = new_uuid()
        upload_path = f"{_upload_root(bucket, object_)}/{upload_id}"
        # The geometry and codec are fixed at initiate time and journaled:
        # every part and the complete use them.
        codec_id = registry.select_codec(data_blocks, parity,
                                         forced=opts.codec,
                                         device=self.device)
        fi = FileInfo(
            volume=SYSTEM_META_BUCKET,
            name=upload_path,
            mod_time_ns=time.time_ns(),
            metadata={
                **opts.user_defined,
                "x-mtpu-internal-object": f"{bucket}/{object_}",
            },
            erasure=ErasureInfo(
                algorithm=registry.get(codec_id).wire_algorithm,
                data_blocks=data_blocks,
                parity_blocks=parity,
                block_size=self._block_size(),
                distribution=hash_order(f"{bucket}/{object_}", n),
                codec=codec_id,
            ),
        )

        def write(i, disk):
            f = FileInfo.from_dict(fi.to_dict())
            f.erasure.index = i + 1
            disk.write_metadata(SYSTEM_META_BUCKET, upload_path, f)

        err = reduce_write_quorum_errs(self._on_every_disk(write),
                                       OBJECT_OP_IGNORED_ERRS, write_quorum)
        if err is not None:
            raise err
        return upload_id

    def _upload_fi(self, bucket: str, object_: str, upload_id: str):
        upload_path = f"{_upload_root(bucket, object_)}/{upload_id}"
        fis, errs = read_all_file_info(self.disks, SYSTEM_META_BUCKET,
                                       upload_path)
        valid = [fi for fi in fis if fi is not None]
        if not valid:
            raise ErrInvalidUploadID(upload_id)
        mt, dd = common_mod_time(fis)
        read_quorum = valid[0].erasure.data_blocks or len(self.disks) // 2
        err = reduce_read_quorum_errs(errs, OBJECT_OP_IGNORED_ERRS,
                                      read_quorum)
        if err is not None:
            raise ErrInvalidUploadID(upload_id)
        fi = find_file_info_in_quorum(fis, mt, dd, read_quorum)
        return fi, fis, upload_path

    def put_object_part(self, bucket: str, object_: str, upload_id: str,
                        part_number: int, reader, size: int,
                        opts: ObjectOptions | None = None) -> PartInfo:
        if not 1 <= part_number <= MAX_PART_ID:
            raise ErrInvalidPart(f"part number {part_number}")
        # The PUT's admission: a whole part a slot on one core, else the
        # encode alone.
        if fanout.SINGLE_CORE:
            with fanout.encode_slot():
                pi = self._put_object_part_inner(
                    bucket, object_, upload_id, part_number, reader, size,
                    opts)
        else:
            pi = self._put_object_part_inner(bucket, object_, upload_id,
                                             part_number, reader, size, opts)
        # Source bytes of a committed part, as put_object's.
        ioflow.logical(pi.size)
        return pi

    def _put_object_part_inner(self, bucket: str, object_: str,
                               upload_id: str, part_number: int, reader,
                               size: int, opts: ObjectOptions | None
                               ) -> PartInfo:
        fi, _, upload_path = self._upload_fi(bucket, object_, upload_id)
        k, m = fi.erasure.data_blocks, fi.erasure.parity_blocks
        write_quorum = k + (1 if k == m else 0)
        erasure = self._object_erasure(k, m, fi.erasure.block_size,
                                       fi.erasure.codec)
        disks_by_shard = shuffle_disks(self.disks, fi.erasure.distribution)

        tee = TeeMD5Reader(reader, size=size)
        # Staged under a tmp name: a re-upload of a part number must not
        # clobber the journaled shards until it has fully verified.
        tmp_part = f"part.{part_number}.tmp.{new_uuid()}"
        phys_shard = (bitrot_shard_file_size(erasure.shard_file_size(size),
                                             erasure.shard_size())
                      if size >= 0 else -1)
        writers: list = [None] * len(disks_by_shard)
        sinks: list = [None] * len(disks_by_shard)
        for i, disk in enumerate(disks_by_shard):
            if disk is None:
                continue
            try:
                sinks[i] = disk.create_file_writer(
                    SYSTEM_META_BUCKET, f"{upload_path}/{tmp_part}",
                    size=phys_shard)
            except (StorageError, OSError):
                continue  # offline at open time: this shard heals later
            writers[i] = StreamingBitrotWriter(sinks[i], device=self.device)

        def close_sinks():
            for s in sinks:
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass

        def drop_tmp():
            close_sinks()
            for disk in disks_by_shard:
                if disk is None:
                    continue
                try:
                    disk.delete(SYSTEM_META_BUCKET,
                                f"{upload_path}/{tmp_part}")
                except (StorageError, OSError):
                    pass

        try:
            if fanout.SINGLE_CORE:  # inside the whole-part slot
                total = encode_stream(erasure, tee, writers, write_quorum,
                                      telemetry="multipart")
            else:
                with fanout.encode_slot():
                    total = encode_stream(erasure, tee, writers,
                                          write_quorum,
                                          telemetry="multipart")
        except BaseException:
            drop_tmp()
            raise
        close_sinks()
        if size >= 0 and total != size:
            drop_tmp()
            raise ErrLessData(f"read {total}, want {size}")
        etag = tee.md5_hex()
        if opts is not None and opts.want_md5_hex and \
                etag != opts.want_md5_hex:
            # A bad digest drops the staged shards before the journal,
            # or an earlier upload of the part, is touched.
            drop_tmp()
            raise ErrBadDigest(
                f"part md5 {etag} != declared {opts.want_md5_hex}")
        # Move the part into place on every disk that took the stream,
        # under the stream's write quorum.
        rename_errs: list = [None] * len(disks_by_shard)
        renamed = 0
        for i, disk in enumerate(disks_by_shard):
            if disk is None or writers[i] is None:
                rename_errs[i] = ErrDiskNotFound(f"disk {i}")
                continue
            try:
                disk.rename_file(
                    SYSTEM_META_BUCKET, f"{upload_path}/{tmp_part}",
                    SYSTEM_META_BUCKET, f"{upload_path}/part.{part_number}")
                renamed += 1
            except (StorageError, OSError) as exc:
                rename_errs[i] = exc
        if renamed < write_quorum:
            # The part's shards are now of mixed uploads across disks:
            # drop it from the journal, so a complete fails InvalidPart
            # instead of assembling them.
            drop_tmp()
            if any(p.number == part_number for p in fi.parts):
                self._journal_remove_part(upload_path, part_number)
            err = reduce_write_quorum_errs(
                rename_errs, OBJECT_OP_IGNORED_ERRS, write_quorum)
            raise err if err else ErrErasureWriteQuorum(
                f"part {part_number}: {renamed} renames succeeded")

        def journal(_, disk):
            f = disk.read_version(SYSTEM_META_BUCKET, upload_path)
            f.add_part(part_number, total, total)
            f.metadata[_part_etag_key(part_number)] = etag
            f.erasure.checksums = [
                c for c in f.erasure.checksums
                if c.part_number != part_number
            ] + [ChecksumInfo(part_number, _HIGHWAYHASH)]
            disk.write_metadata(SYSTEM_META_BUCKET, upload_path, f)

        # The journal update is a read-modify-write: one part's at a
        # time for an upload.
        with self._ns_lock.write(f"{SYSTEM_META_BUCKET}/{upload_path}"):
            errs = self._on_every_disk(journal)
        err = reduce_write_quorum_errs(errs, OBJECT_OP_IGNORED_ERRS,
                                       write_quorum)
        if err is not None:
            raise err
        return PartInfo(part_number=part_number, etag=etag, size=total,
                        actual_size=total, mod_time_ns=time.time_ns())

    def _journal_remove_part(self, upload_path: str,
                             part_number: int) -> None:
        """Drop a part from every disk's upload journal, best effort."""

        def drop(_, disk):
            f = disk.read_version(SYSTEM_META_BUCKET, upload_path)
            f.parts = [p for p in f.parts if p.number != part_number]
            f.metadata.pop(_part_etag_key(part_number), None)
            f.erasure.checksums = [c for c in f.erasure.checksums
                                   if c.part_number != part_number]
            disk.write_metadata(SYSTEM_META_BUCKET, upload_path, f)

        with self._ns_lock.write(f"{SYSTEM_META_BUCKET}/{upload_path}"):
            self._on_every_disk(drop)

    def list_object_parts(self, bucket: str, object_: str, upload_id: str,
                          part_marker: int = 0,
                          max_parts: int = 1000) -> list[PartInfo]:
        fi, _, _ = self._upload_fi(bucket, object_, upload_id)
        out = []
        for p in fi.parts:
            if p.number <= part_marker:
                continue
            out.append(PartInfo(
                part_number=p.number,
                etag=fi.metadata.get(_part_etag_key(p.number), ""),
                size=p.size, actual_size=p.actual_size,
            ))
            if len(out) >= max_parts:
                break
        return out

    def list_multipart_uploads(self, bucket: str,
                               prefix: str = "") -> list[MultipartInfo]:
        out = []
        seen = set()
        for disk in self.disks:
            if disk is None:
                continue
            try:
                for name, meta_blob in disk.walk_dir(SYSTEM_META_BUCKET,
                                                     "multipart"):
                    if name in seen:
                        continue
                    seen.add(name)
                    fi = XLMeta.from_bytes(meta_blob).to_file_info(
                        SYSTEM_META_BUCKET, name, None)
                    target = fi.metadata.get("x-mtpu-internal-object", "")
                    if "/" not in target:
                        continue
                    b, o = target.split("/", 1)
                    if b != bucket or (prefix and not o.startswith(prefix)):
                        continue
                    out.append(MultipartInfo(
                        bucket=b, object=o,
                        upload_id=name.rsplit("/", 1)[-1],
                        user_defined=fi.metadata,
                    ))
            except (StorageError, OSError, ValueError):
                continue  # an unreadable disk or journal: the next disk
        return out

    def abort_multipart_upload(self, bucket: str, object_: str,
                               upload_id: str) -> None:
        _, _, upload_path = self._upload_fi(bucket, object_, upload_id)
        self._on_every_disk(lambda _, d: d.delete(
            SYSTEM_META_BUCKET, upload_path, recursive=True))

    def complete_multipart_upload(self, bucket: str, object_: str,
                                  upload_id: str, parts: list[CompletePart],
                                  opts: ObjectOptions | None = None
                                  ) -> ObjectInfo:
        opts = opts or ObjectOptions()
        fi, _, upload_path = self._upload_fi(bucket, object_, upload_id)
        k, m = fi.erasure.data_blocks, fi.erasure.parity_blocks
        write_quorum = k + (1 if k == m else 0)

        # The parts named must be strictly ascending, journaled, and of
        # the journaled ETag (cmd/erasure-multipart.go:736-860).
        if not parts:
            raise ErrInvalidPart("no parts given")
        for a, b in zip(parts, parts[1:]):
            if b.part_number <= a.part_number:
                raise ErrInvalidPart(f"part order invalid: {a.part_number} "
                                     f"then {b.part_number}")
        by_number = {p.number: p for p in fi.parts}
        md5s = []
        total_size = 0
        final_parts = []
        for cp in parts:
            jp = by_number.get(cp.part_number)
            want_etag = fi.metadata.get(_part_etag_key(cp.part_number), "")
            if jp is None or (cp.etag and cp.etag != want_etag):
                raise ErrInvalidPart(f"part {cp.part_number}")
            md5s.append(bytes.fromhex(want_etag))
            total_size += jp.size
            final_parts.append(jp)

        etag = compute_parts_etag(md5s)
        mod_time_ns = time.time_ns()
        version_id = opts.version_id or (new_uuid() if opts.versioned
                                         else "")
        data_dir = new_uuid()
        metadata = {kk: v for kk, v in fi.metadata.items()
                    if not kk.startswith("x-mtpu-internal-")}
        metadata["etag"] = etag
        metadata.setdefault("content-type", "application/octet-stream")
        disks_by_shard = shuffle_disks(self.disks, fi.erasure.distribution)

        def commit(shard_i, disk):
            f = FileInfo(
                volume=bucket, name=object_, version_id=version_id,
                data_dir=data_dir, mod_time_ns=mod_time_ns, size=total_size,
                metadata=dict(metadata),
                erasure=ErasureInfo(
                    algorithm=fi.erasure.algorithm,
                    data_blocks=k, parity_blocks=m,
                    block_size=fi.erasure.block_size, index=shard_i + 1,
                    distribution=list(fi.erasure.distribution),
                    checksums=[ChecksumInfo(p.number, _HIGHWAYHASH)
                               for p in final_parts],
                    codec=fi.erasure.codec,
                ),
            )
            for p in final_parts:
                f.add_part(p.number, p.size, p.actual_size)
            try:
                # Drop the upload journal so only part files move.
                disk.delete(SYSTEM_META_BUCKET, f"{upload_path}/xl.meta")
            except (StorageError, OSError):
                pass
            disk.rename_data(SYSTEM_META_BUCKET, upload_path, f, bucket,
                             object_)

        errs: list = [None] * len(disks_by_shard)

        def attempt(i):
            if disks_by_shard[i] is None:
                raise ErrDiskNotFound(f"disk {i}")
            commit(i, disks_by_shard[i])

        from .erasure_objects import _quorum_fanout

        # The commit writes the object's xl.meta: the object's write lock,
        # as a PUT takes it. It returns at write quorum plus a straggler
        # grace; a drive hung in rename_data is detached and MRF heals it.
        with self._locked(bucket, object_, writer=True):
            _quorum_fanout(attempt, disks_by_shard, errs, write_quorum)
        err = reduce_write_quorum_errs(errs, OBJECT_OP_IGNORED_ERRS,
                                       write_quorum)
        if err is not None:
            raise err
        if any(e is not None for e in errs):
            self.queue_mrf(bucket, object_, version_id)  # partial commit

        out = FileInfo(
            volume=bucket, name=object_, version_id=version_id,
            mod_time_ns=mod_time_ns, size=total_size, metadata=metadata,
            erasure=ErasureInfo(algorithm=fi.erasure.algorithm,
                                data_blocks=k, parity_blocks=m,
                                codec=fi.erasure.codec),
        )
        return ObjectInfo.from_file_info(out, bucket, object_, opts.versioned)

"""Error types raised by the erasure data plane, the drive storage and
the object layer.

The class names and their hierarchy match minio_tpu.utils.errors (itself
the reference's taxonomy, cmd/typed-errors.go and cmd/storage-errors.go)
so callers that classify by name see the same errors from either package.
"""

from __future__ import annotations


class StorageError(Exception):
    """Base class for storage-layer errors."""


class ErrDiskNotFound(StorageError):
    """Disk is offline / not found (errDiskNotFound)."""


class ErrDiskFaulty(ErrDiskNotFound):
    """Disk latched faulty by the health breaker after repeated op
    timeouts, or out of in-flight tokens (errFaultyDisk). An
    ErrDiskNotFound, so every quorum reduction treats a faulty disk as an
    offline one."""


class ErrDiskOpTimeout(ErrDiskFaulty):
    """One storage op outlived its deadline: a drive op past its
    per-op deadline, a shard writer detached past write quorum, or a
    shard reader abandoned past a hedge. The op may still complete in the
    background; heal repairs what it missed."""


class ErrFileNotFound(StorageError):
    """File not found on disk (errFileNotFound): triggers missing-part heal."""


class ErrFileVersionNotFound(StorageError):
    """Requested version not found (errFileVersionNotFound)."""


class ErrFileCorrupt(StorageError):
    """Bitrot verification failed (errFileCorrupt): triggers bitrot heal."""


class ErrFileAccessDenied(StorageError):
    """Access denied on the path (errFileAccessDenied)."""


class ErrVolumeNotFound(StorageError):
    """Volume (bucket directory) not found (errVolumeNotFound)."""


class ErrVolumeExists(StorageError):
    """Volume already exists (errVolumeExists)."""


class ErrVolumeNotEmpty(StorageError):
    """Volume not empty on delete (errVolumeNotEmpty)."""


class ErrCorruptedFormat(StorageError):
    """format.json or xl.meta unusable (errCorruptedFormat)."""


class ErrUnformattedDisk(StorageError):
    """Fresh disk without format.json (errUnformattedDisk)."""


class ErrErasureReadQuorum(StorageError):
    """Read quorum unavailable (errErasureReadQuorum)."""


class ErrErasureWriteQuorum(StorageError):
    """Write quorum unavailable (errErasureWriteQuorum)."""


class ErrLessData(StorageError):
    """Fewer bytes available than requested (errLessData)."""


class ErrInvalidArgument(StorageError):
    """Invalid arguments provided (errInvalidArgument)."""


class ErrMethodNotAllowed(StorageError):
    """Operation not allowed, e.g. a GET of a delete marker
    (errMethodNotAllowed)."""


class ErrObjectNotFound(StorageError):
    """Object does not exist (ObjectNotFound)."""


class ErrVersionNotFound(StorageError):
    """Object version does not exist (VersionNotFound)."""


class ErrBucketNotFound(StorageError):
    """Bucket does not exist (BucketNotFound)."""


class ErrBadDigest(StorageError):
    """Content MD5 differs from the one the client declared (BadDigest)."""


class ErrOperationTimedOut(StorageError):
    """Namespace-lock acquisition timed out (OperationTimedOut)."""


class ErrPreconditionFailed(StorageError):
    """The object is not the one the caller's precondition names
    (PreconditionFailed)."""


class ErrInvalidUploadID(StorageError):
    """No multipart upload of that id (InvalidUploadID)."""


class ErrInvalidPart(StorageError):
    """A multipart part is missing, out of order or has another ETag
    (InvalidPart)."""


class ErrQuotaExceeded(StorageError):
    """A write would cross the bucket's hard quota (BucketQuotaExceeded,
    cmd/bucket-quota.go)."""


class RSError(Exception):
    """Base class for Reed-Solomon codec errors (klauspost/reedsolomon)."""


class ErrInvShardNum(RSError):
    """data/parity shard count <= 0."""


class ErrMaxShardNum(RSError):
    """data+parity > 256 shards."""


class ErrShortData(RSError):
    """Not enough data to fill the requested shards."""


class ErrTooFewShards(RSError):
    """Too few shards present to reconstruct."""


class ErrShardSize(RSError):
    """Shards are not identically sized."""


class ErrReconstructRequired(RSError):
    """A data shard is missing; reconstruction needed before join."""


# Errors skipped by quorum reduction: the disk is gone or unformatted,
# which says nothing about the object (objectOpIgnoredErrs).
OBJECT_OP_IGNORED_ERRS = (ErrDiskNotFound, ErrUnformattedDisk)


def reduce_errs(errs, ignored_errs=()):
    """(count, err) of the most frequent outcome, success counted as None
    and preferred on ties (reduceErrs, cmd/erasure-metadata-utils.go)."""
    counts: dict[object, int] = {}
    keys: dict[object, object] = {}
    ignored = tuple(ignored_errs)
    for e in errs:
        if e is not None and ignored and isinstance(e, ignored):
            continue
        k = None if e is None else type(e)
        counts[k] = counts.get(k, 0) + 1
        keys.setdefault(k, e)
    max_k, max_n = None, 0
    for k, n in counts.items():
        if n > max_n or (n == max_n and k is None):
            max_k, max_n = k, n
    return max_n, keys.get(max_k)


def reduce_quorum_errs(errs, ignored_errs, quorum: int,
                       quorum_err: StorageError):
    """None if the most frequent outcome reaches quorum and is success,
    that outcome's error if it reaches quorum, else `quorum_err`."""
    max_count, max_err = reduce_errs(errs, ignored_errs)
    if max_count >= quorum:
        return max_err
    return quorum_err


def reduce_read_quorum_errs(errs, ignored_errs, read_quorum: int):
    return reduce_quorum_errs(errs, ignored_errs, read_quorum,
                              ErrErasureReadQuorum())


def reduce_write_quorum_errs(errs, ignored_errs, write_quorum: int):
    return reduce_quorum_errs(errs, ignored_errs, write_quorum,
                              ErrErasureWriteQuorum())

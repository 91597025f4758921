"""Object-layer metadata helpers, the port's copy of
minio_tpu/object/metadata.py (MinIO's cmd/erasure-metadata-utils.go and
cmd/erasure-metadata.go): the shard order of an object, reading every
disk's xl.meta, quorum agreement on one version, and ordering disks by
shard index.
"""

from __future__ import annotations

import hashlib
import zlib
from concurrent.futures import ThreadPoolExecutor

from ..observability import carry as obs_carry
from ..storage.fileinfo import FileInfo
from ..utils.errors import (
    OBJECT_OP_IGNORED_ERRS,
    ErrDiskNotFound,
    ErrErasureReadQuorum,
    reduce_read_quorum_errs,
)

# Fan-out over drives. Its threads do file I/O only: kernel launches and
# device copies stay on the thread that drives the stream. No thread
# starts before the first submit.
IO_POOL = ThreadPoolExecutor(max_workers=32,
                             thread_name_prefix="mtpu-torch-io")


def start_io_pool() -> None:
    """Start every worker of IO_POOL now (a server on the card does it
    when it starts)."""
    from ..utils.fanout import prestart

    prestart(IO_POOL, IO_POOL._max_workers)


def fanout(fn, n: int) -> None:
    """Run fn(i) for i in range(n) on IO_POOL and wait for all; fn
    records its own outcome, so an exception here is a bug and raises."""
    fn = obs_carry(fn)
    for fut in [IO_POOL.submit(fn, i) for i in range(n)]:
        fut.result()


def hash_order(key: str, cardinality: int) -> list[int]:
    """Consistent 1-based shard rotation for an object key (hashOrder)."""
    if cardinality <= 0:
        return []
    key_crc = zlib.crc32(key.encode()) & 0xFFFFFFFF
    start = key_crc % cardinality
    return [1 + ((start + i) % cardinality)
            for i in range(1, cardinality + 1)]


def read_all_file_info(disks: list, bucket: str, object_: str,
                       version_id: str = "", read_data: bool = False):
    """Read xl.meta from every disk in parallel; (fis, errs) with None
    in the places that failed (readAllFileInfo)."""
    fis: list[FileInfo | None] = [None] * len(disks)
    errs: list = [None] * len(disks)

    def do(i):
        if disks[i] is None:
            errs[i] = ErrDiskNotFound(f"disk {i}")
            return
        try:
            fis[i] = disks[i].read_version(bucket, object_, version_id,
                                           read_data)
        except Exception as exc:  # noqa: BLE001 - collected for quorum
            errs[i] = exc

    fanout(do, len(disks))
    return fis, errs


def _meta_hash(fi: FileInfo) -> str:
    h = hashlib.sha256()
    for part in fi.parts:
        h.update(f"part.{part.number}".encode())
    h.update(str(fi.erasure.distribution).encode())
    # Disks that disagree on the codec never merge into one version.
    h.update(fi.erasure.codec.encode())
    h.update(str(len(fi.data)).encode())
    return h.hexdigest()


def find_file_info_in_quorum(metas: list, mod_time_ns: int, data_dir: str,
                             quorum: int) -> FileInfo:
    """The FileInfo that >= quorum disks agree on
    (findFileInfoInQuorum)."""
    hashes = [None] * len(metas)
    for i, fi in enumerate(metas):
        if (fi is not None and fi.mod_time_ns == mod_time_ns
                and fi.data_dir == data_dir):
            hashes[i] = _meta_hash(fi)
    counts: dict[str, int] = {}
    for h in hashes:
        if h:
            counts[h] = counts.get(h, 0) + 1
    max_hash, max_count = "", 0
    for h, c in counts.items():
        if c > max_count:
            max_hash, max_count = h, c
    if max_count < quorum:
        raise ErrErasureReadQuorum(f"meta quorum {max_count} < {quorum}")
    for i, h in enumerate(hashes):
        if h == max_hash:
            return metas[i]
    raise ErrErasureReadQuorum("no meta in quorum")


def common_mod_time(metas: list) -> tuple[int, str]:
    """The (mod_time_ns, data_dir) that occurs most often
    (commonTime / commonDataDir)."""
    counts: dict[tuple[int, str], int] = {}
    for fi in metas:
        if fi is None:
            continue
        key = (fi.mod_time_ns, fi.data_dir)
        counts[key] = counts.get(key, 0) + 1
    if not counts:
        raise ErrErasureReadQuorum("no valid metadata")
    (mt, dd), _ = max(counts.items(), key=lambda kv: kv[1])
    return mt, dd


def object_quorum_from_meta(metas: list, errs: list,
                            default_parity: int) -> tuple[int, int]:
    """(read_quorum, write_quorum) of an existing object
    (objectQuorumFromMeta)."""
    valid_any = [fi for fi in metas if fi is not None]
    if not valid_any:
        err = reduce_read_quorum_errs(errs, OBJECT_OP_IGNORED_ERRS, 1)
        raise err if err else ErrErasureReadQuorum("no valid metadata")
    mt, dd = common_mod_time(metas)
    latest = next(
        (fi for fi in valid_any if fi.mod_time_ns == mt and fi.data_dir == dd),
        valid_any[0],
    )
    if latest.erasure.data_blocks <= 0:
        # A delete marker has no erasure geometry: majority quorum.
        half = len(metas) // 2
        return half, half + 1
    data_blocks = latest.erasure.data_blocks
    parity = latest.erasure.parity_blocks or default_parity
    write_quorum = data_blocks + (1 if data_blocks == parity else 0)
    return data_blocks, write_quorum


def shuffle_disks(disks: list, distribution: list[int]) -> list:
    """Disks in shard order: result[s] is the disk holding shard s+1
    (shuffleDisks)."""
    if not distribution:
        return list(disks)
    shuffled = [None] * len(disks)
    for i, block_index in enumerate(distribution):
        shuffled[block_index - 1] = disks[i]
    return shuffled


def shuffle_disks_and_parts_metadata(disks: list, metas: list,
                                     fi: FileInfo) -> tuple[list, list]:
    """Disks and metas in shard order, leaving out the entries whose
    metadata disagrees with fi (shuffleDisksAndPartsMetadataByIndex)."""
    shuffled_disks = [None] * len(disks)
    shuffled_metas: list = [None] * len(disks)
    for i, block_index in enumerate(fi.erasure.distribution):
        if metas[i] is None:
            continue
        if (metas[i].mod_time_ns != fi.mod_time_ns
                or metas[i].data_dir != fi.data_dir):
            continue
        shuffled_disks[block_index - 1] = disks[i]
        shuffled_metas[block_index - 1] = metas[i]
    return shuffled_disks, shuffled_metas

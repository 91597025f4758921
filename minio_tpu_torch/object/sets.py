"""ErasureSets: one pool of N erasure sets of set_drive_count disks each,
placing each object on a set by SipHash(object) % N keyed on the
deployment id, and keeping format.json on every disk. The port's copy of
minio_tpu/object/sets.py (MinIO's cmd/erasure-sets.go and
cmd/format-erasure.go), with the object, multipart, heal and listing
calls of the port's ErasureObjects.
"""

from __future__ import annotations

import hashlib
import heapq
import json
import uuid

from ..storage.fileinfo import new_uuid
from ..storage.local import SYSTEM_META_BUCKET
from ..utils.errors import (
    ErrCorruptedFormat,
    ErrFileNotFound,
    ErrUnformattedDisk,
    ErrVolumeNotFound,
    StorageError,
)
from ..utils.siphash import crc_hash_mod, siphash_mod
from .erasure_objects import ErasureObjects
from .types import BucketInfo

FORMAT_FILE = "format.json"

# Distribution algorithm tags (cmd/format-erasure.go).
DIST_ALGO_CRC = "CRCMOD"
DIST_ALGO_SIPMOD = "SIPMOD+PARITY"


def write_format(disk, deployment_id: str, disk_id: str,
                 layout: list[list[str]],
                 distribution_algo: str = DIST_ALGO_SIPMOD) -> None:
    """Write one disk's format.json, as minio_tpu writes it."""
    doc = {
        "version": "1",
        "format": "xl-tpu",
        "id": deployment_id,
        "xl": {
            "version": "3",
            "this": disk_id,
            "sets": layout,
            "distributionAlgo": distribution_algo,
        },
    }
    disk.write_all(SYSTEM_META_BUCKET, FORMAT_FILE, json.dumps(doc).encode())


def read_format(disk) -> dict:
    try:
        raw = disk.read_all(SYSTEM_META_BUCKET, FORMAT_FILE)
    except (ErrFileNotFound, ErrVolumeNotFound) as exc:
        raise ErrUnformattedDisk(disk.endpoint()) from exc
    try:
        doc = json.loads(raw)
    except json.JSONDecodeError as exc:
        raise ErrCorruptedFormat(disk.endpoint()) from exc
    if not isinstance(doc, dict) or doc.get("format") != "xl-tpu":
        raise ErrCorruptedFormat(f"{disk.endpoint()}: bad format tag")
    return doc


class ErasureSets:
    """One pool of set_count x set_drive_count disks. `device` runs the
    kernels of every set; it defaults to the card and raises at
    construction when there is none."""

    def __init__(self, disks: list, set_drive_count: int,
                 deployment_id: str | None = None,
                 default_parity: int | None = None, pool_index: int = 0,
                 device="cuda"):
        if len(disks) % set_drive_count != 0:
            raise ValueError("disk count must be a multiple of "
                             "set_drive_count")
        self.set_count = len(disks) // set_drive_count
        self.set_drive_count = set_drive_count
        self.disks = list(disks)
        self.pool_index = pool_index
        self.distribution_algo = DIST_ALGO_SIPMOD
        self.deployment_id = deployment_id or new_uuid()
        self.sets = [
            ErasureObjects(
                disks[s * set_drive_count:(s + 1) * set_drive_count],
                default_parity=default_parity, set_index=s,
                pool_index=pool_index, device=device)
            for s in range(self.set_count)]

    # --- format (cmd/format-erasure.go, cmd/prepare-storage.go) ---

    def init_format(self) -> None:
        """Write a fresh format.json to every disk (a new deployment)."""
        layout = [[f"disk-{s}-{d}" for d in range(self.set_drive_count)]
                  for s in range(self.set_count)]
        for s in range(self.set_count):
            for d in range(self.set_drive_count):
                disk = self.disks[s * self.set_drive_count + d]
                if disk is None:
                    continue
                write_format(disk, self.deployment_id, layout[s][d], layout,
                             self.distribution_algo)
                disk.set_disk_id(layout[s][d])

    def load_format(self) -> None:
        """Read format.json from the disks and take the deployment id and
        distribution algorithm most of them agree on; unformatted,
        corrupt and unreachable disks are skipped."""
        ids: dict[str, int] = {}
        algos: dict[str, int] = {}
        for disk in self.disks:
            if disk is None:
                continue
            try:
                doc = read_format(disk)
            except StorageError:
                continue
            ids[doc["id"]] = ids.get(doc["id"], 0) + 1
            algo = doc["xl"].get("distributionAlgo", DIST_ALGO_SIPMOD)
            algos[algo] = algos.get(algo, 0) + 1
            disk.set_disk_id(doc["xl"]["this"])
        if not ids:
            raise ErrUnformattedDisk("no formatted disks")
        self.deployment_id = max(ids.items(), key=lambda kv: kv[1])[0]
        self.distribution_algo = max(algos.items(), key=lambda kv: kv[1])[0]
        self.cleanup_stale_tmp()

    def cleanup_stale_tmp(self) -> int:
        """Purge staged writes that a process killed mid-PUT left under
        every disk's tmp; returns the entries removed."""
        purged = 0
        for disk in self.disks:
            if disk is None:
                continue
            try:
                purged += disk.purge_stale_tmp()
            except (StorageError, OSError):
                continue
        return purged

    @property
    def deployment_id_bytes(self) -> bytes:
        try:
            return uuid.UUID(self.deployment_id).bytes
        except ValueError:
            return hashlib.md5(self.deployment_id.encode()).digest()

    # --- placement (cmd/erasure-sets.go) ---

    def get_hashed_set_index(self, object_: str) -> int:
        if self.distribution_algo == DIST_ALGO_CRC:
            return crc_hash_mod(object_, self.set_count)
        return siphash_mod(object_, self.set_count, self.deployment_id_bytes)

    def get_hashed_set(self, object_: str) -> ErasureObjects:
        return self.sets[self.get_hashed_set_index(object_)]

    # --- object layer: each call goes to the object's set ---

    def make_bucket(self, bucket: str) -> None:
        for s in self.sets:
            s.make_bucket(bucket)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        for s in self.sets:
            s.delete_bucket(bucket, force=force)

    def bucket_exists(self, bucket: str) -> bool:
        return all(s.bucket_exists(bucket) for s in self.sets)

    def list_buckets(self) -> list[BucketInfo]:
        seen: dict[str, int] = {}
        for disk in self.disks:
            if disk is None:
                continue
            try:
                vols = disk.list_vols()
            except (StorageError, OSError):
                continue
            for v in vols:
                if not v.name.startswith("."):
                    seen.setdefault(v.name, v.created_ns)
        return [BucketInfo(name=n, created_ns=c)
                for n, c in sorted(seen.items())]

    def put_object(self, bucket, object_, reader, size, opts=None):
        return self.get_hashed_set(object_).put_object(bucket, object_,
                                                       reader, size, opts)

    def get_object(self, bucket, object_, writer, offset=0, length=-1,
                   opts=None):
        return self.get_hashed_set(object_).get_object(
            bucket, object_, writer, offset, length, opts)

    def get_object_info(self, bucket, object_, opts=None):
        return self.get_hashed_set(object_).get_object_info(bucket, object_,
                                                            opts)

    def delete_object(self, bucket, object_, opts=None):
        return self.get_hashed_set(object_).delete_object(bucket, object_,
                                                          opts)

    def delete_objects(self, bucket, objects, opts=None):
        return [self._delete_one(bucket, o, opts) for o in objects]

    def _delete_one(self, bucket, object_, opts):
        try:
            self.get_hashed_set(object_).delete_object(bucket, object_, opts)
            return None
        except StorageError as exc:
            return exc

    def update_object_metadata(self, bucket, object_, version_id, updates,
                               replace_user_meta=False):
        return self.get_hashed_set(object_).update_object_metadata(
            bucket, object_, version_id, updates, replace_user_meta)

    def transition_object(self, bucket, object_, version_id, updates,
                          **guard):
        return self.get_hashed_set(object_).transition_object(
            bucket, object_, version_id, updates, **guard)

    def restore_object(self, bucket, object_, version_id, reader, size,
                       updates, **guard):
        return self.get_hashed_set(object_).restore_object(
            bucket, object_, version_id, reader, size, updates, **guard)

    def heal_object(self, bucket, object_, version_id="",
                    remove_dangling=False):
        return self.get_hashed_set(object_).heal_object(
            bucket, object_, version_id, remove_dangling)

    def heal_bucket(self, bucket):
        return [s.heal_bucket(bucket) for s in self.sets]

    def list_objects_raw(self, bucket: str, prefix: str = ""):
        """Merge the sets' sorted streams (k-way merge by name)."""
        iters = [s.list_objects_raw(bucket, prefix) for s in self.sets]
        return heapq.merge(*iters, key=lambda t: t[0])

    # --- multipart: each call goes to the object's set ---

    def new_multipart_upload(self, bucket, object_, opts=None):
        return self.get_hashed_set(object_).new_multipart_upload(
            bucket, object_, opts)

    def put_object_part(self, bucket, object_, upload_id, part_number,
                        reader, size, opts=None):
        return self.get_hashed_set(object_).put_object_part(
            bucket, object_, upload_id, part_number, reader, size, opts)

    def list_object_parts(self, bucket, object_, upload_id, part_marker=0,
                          max_parts=1000):
        return self.get_hashed_set(object_).list_object_parts(
            bucket, object_, upload_id, part_marker, max_parts)

    def list_multipart_uploads(self, bucket, prefix=""):
        out = []
        for s in self.sets:
            out.extend(s.list_multipart_uploads(bucket, prefix))
        return out

    def abort_multipart_upload(self, bucket, object_, upload_id):
        return self.get_hashed_set(object_).abort_multipart_upload(
            bucket, object_, upload_id)

    def complete_multipart_upload(self, bucket, object_, upload_id, parts,
                                  opts=None):
        return self.get_hashed_set(object_).complete_multipart_upload(
            bucket, object_, upload_id, parts, opts)

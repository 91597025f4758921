"""Fresh-drive detection and the resumable set-wide heal, the port's copy
of minio_tpu/background/newdisk.py (MinIO's initAutoHeal and
healingTracker, cmd/background-newdisks-heal-ops.go, and
healErasureSet, cmd/global-heal.go:154).

A replaced drive is found by its missing format.json, given the identity
its slot has in the set's layout, marked with a healing tracker stored
on the drive itself, and back-filled by a sweep of every version its set
owns, whose progress survives a restart.
"""

from __future__ import annotations

import json
import threading
import time

from ..bucket.metadata import META_BUCKET
from ..object.sets import read_format, write_format
from ..storage.local import SYSTEM_META_BUCKET
from ..utils.errors import ErrCorruptedFormat, ErrUnformattedDisk, StorageError

TRACKER_PATH = "healing.json"


class HealingTracker:
    """The progress of a drive's heal, stored on that drive (MinIO's
    healingTracker at .minio.sys/healing.bin)."""

    def __init__(self, disk_id: str = "", endpoint: str = "",
                 started_ns: int = 0, last_bucket: str = "",
                 last_object: str = "", objects_healed: int = 0,
                 objects_failed: int = 0, finished: bool = False):
        self.disk_id = disk_id
        self.endpoint = endpoint
        self.started_ns = started_ns or time.time_ns()
        self.last_bucket = last_bucket
        self.last_object = last_object
        self.objects_healed = objects_healed
        self.objects_failed = objects_failed
        self.finished = finished

    def to_dict(self) -> dict:
        return dict(vars(self))

    @classmethod
    def from_dict(cls, d: dict) -> "HealingTracker":
        return cls(**{k: d.get(k) for k in (
            "disk_id", "endpoint", "started_ns", "last_bucket",
            "last_object", "objects_healed", "objects_failed", "finished")})

    def save(self, disk) -> None:
        disk.write_all(SYSTEM_META_BUCKET, TRACKER_PATH,
                       json.dumps(self.to_dict()).encode())

    @classmethod
    def load(cls, disk) -> "HealingTracker | None":
        try:
            return cls.from_dict(
                json.loads(disk.read_all(SYSTEM_META_BUCKET, TRACKER_PATH)))
        except (StorageError, ValueError):
            return None

    @staticmethod
    def delete(disk) -> None:
        try:
            disk.delete(SYSTEM_META_BUCKET, TRACKER_PATH)
        except StorageError:
            pass


class FreshDiskHealer:
    """Detect replaced or empty drives and back-fill them.

    A drive whose probe answers but whose format.json is missing is a
    fresh drive (the liveness monitor deals with dead ones). It gets the
    identity the set's layout gives its slot, a HealingTracker, and a
    resumable sweep that heals every object back onto it."""

    def __init__(self, object_layer, interval_s: float = 10.0,
                 checkpoint_every: int = 100):
        self.ol = object_layer
        self.interval_s = interval_s
        self.checkpoint_every = max(1, checkpoint_every)
        self.page_size = 1000  # the listing page (tests shrink it)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.healed_disks: list[str] = []

    def _heal_format(self, es, slot: int, disk) -> bool:
        """Write the slot's format identity onto a fresh drive, from any
        formatted peer's layout (HealFormat)."""
        peer_doc = None
        for other in es.disks:
            if other is None or other is disk:
                continue
            try:
                peer_doc = read_format(other)
                break
            except (ErrUnformattedDisk, ErrCorruptedFormat, StorageError):
                continue
        if peer_doc is None:
            return False  # no reference format: the drive stays out
        layout = peer_doc["xl"]["sets"]
        set_idx = getattr(es, "set_index", 0)
        disk_id = layout[set_idx][slot]
        write_format(disk, peer_doc["id"], disk_id, layout,
                     peer_doc["xl"].get("distributionAlgo", "SIPMOD+PARITY"))
        disk.set_disk_id(disk_id)
        return True

    def check_once(self) -> list[str]:
        """One detection pass; returns the endpoints healed."""
        healed = []
        for pool in getattr(self.ol, "pools", []):
            for es in pool.sets:
                for slot, disk in enumerate(es.disks):
                    if disk is None:
                        continue
                    tracker = None
                    try:
                        read_format(disk)
                        # Formatted: resume only a heal cut short.
                        tracker = HealingTracker.load(disk)
                        if tracker is None or tracker.finished:
                            continue
                    except (ErrUnformattedDisk, ErrCorruptedFormat):
                        if not self._heal_format(es, slot, disk):
                            continue
                    except StorageError:
                        continue  # unreachable: the monitor's business
                    if tracker is None:
                        tracker = HealingTracker(disk_id=disk.get_disk_id(),
                                                 endpoint=disk.endpoint())
                        tracker.save(disk)
                    if self._sweep(es, disk, tracker):
                        healed.append(disk.endpoint())
        return healed

    def _sweep(self, es, disk, tracker: HealingTracker) -> bool:
        """Heal every version, delete markers included, of every key the
        drive's set owns (a latest-only listing would leave noncurrent
        versions short; other sets' keys would multiply the I/O by the
        set count). Returns True when the sweep completed."""
        sets = self._owning_sets(es)
        self._heal_system_volume(es)
        # list_buckets lists user buckets only: the system bucket
        # (.minio.sys) is not swept, as in minio_tpu.
        names = sorted(b.name for b in self.ol.list_buckets())
        for bucket in names:
            if tracker.last_bucket and bucket < tracker.last_bucket:
                continue
            # The bucket's volume first (healErasureSet heals buckets
            # before objects): without it the drive takes no inline
            # object and no delete marker, since their commit writes
            # only xl.meta. (minio_tpu skips this, and those heals fail
            # silently until a part file's rename makes the directory.)
            es.heal_bucket(bucket)
            # last_object is the last key healed whole: key_marker=<it>
            # (no version marker) resumes at the next key.
            page_key = (tracker.last_object
                        if bucket == tracker.last_bucket else "")
            page_vid = ""
            since_ckpt = 0
            # The versions listed so far of a key split across pages. They
            # heal once the key's last page is in: the next page's journal
            # comes from the first drive that has the key, and after a
            # heal that is this drive, whose journal then holds only the
            # versions healed so far. (minio_tpu heals them at once, and
            # its sweep then never lists the key's later versions.)
            carried: list[str] = []
            while True:
                res = self.ol.list_object_versions(
                    bucket, key_marker=page_key,
                    version_id_marker=page_vid, max_keys=self.page_size)
                keys_in_page: list[str] = []
                for v in res.versions:
                    if not keys_in_page or keys_in_page[-1] != v.name:
                        keys_in_page.append(v.name)
                # A truncated page may end inside a key, whose other
                # versions come on the next page: not complete yet.
                split_key = (keys_in_page[-1]
                             if res.is_truncated and keys_in_page else None)
                if carried and keys_in_page[:1] != [page_key]:
                    # The carried key's other versions are gone.
                    self._heal_versions(sets, es, bucket, page_key, carried,
                                        tracker)
                    carried = []
                for key in keys_in_page:
                    vids = [x.version_id for x in res.versions
                            if x.name == key]
                    if carried and key == page_key:
                        vids, carried = carried + vids, []
                    if key == split_key:
                        carried = vids
                        continue  # complete on the next page
                    self._heal_versions(sets, es, bucket, key, vids, tracker)
                    # The checkpoint moves over other sets' keys too, or a
                    # late crash would resume near the bucket's start.
                    tracker.last_bucket = bucket
                    tracker.last_object = key
                    since_ckpt += 1
                    if since_ckpt >= self.checkpoint_every:
                        since_ckpt = 0
                        try:
                            tracker.save(disk)
                        except StorageError:
                            return False  # the drive died; next pass
                try:
                    tracker.save(disk)
                except StorageError:
                    return False  # the drive died; next pass
                if not res.is_truncated:
                    break
                # Both markers, so a split key's other versions are
                # listed, not skipped.
                page_key = res.next_key_marker
                page_vid = res.next_version_id_marker
        tracker.finished = True
        try:
            tracker.save(disk)
            HealingTracker.delete(disk)
        except StorageError:
            return False
        self.healed_disks.append(tracker.endpoint)
        return True

    @staticmethod
    def _heal_system_volume(es) -> None:
        """Make the system bucket's volume on the drives that lack it once
        a drive of the set holds it, as MinIO makes the meta volumes on a
        drive it formats. Without it every later write into .minio.sys
        (the scanner's usage, the config, the bucket metadata) misses the
        fresh drive and queues an MRF heal that cannot make the volume
        either. (minio_tpu never makes it.) Its objects are still not
        swept."""
        for peer in es.disks:
            if peer is None:
                continue
            try:
                peer.stat_vol(META_BUCKET)
            except (StorageError, OSError):
                continue
            es.heal_bucket(META_BUCKET)
            return

    def _heal_versions(self, sets, es, bucket: str, key: str, vids: list,
                       tracker: HealingTracker) -> None:
        """Heal each version of a key the drive's set owns."""
        if sets is not None and sets.get_hashed_set_index(key) != \
                es.set_index:
            return
        for vid in vids:
            try:
                self.ol.heal_object(bucket, key, version_id=vid)
                tracker.objects_healed += 1
            except Exception:  # noqa: BLE001 - counted
                tracker.objects_failed += 1

    def _owning_sets(self, es):
        """The ErasureSets holding `es`, None when it has one set."""
        for pool in getattr(self.ol, "pools", []):
            if es in getattr(pool, "sets", []):
                return pool if pool.set_count > 1 else None
        return None

    def start(self) -> "FreshDiskHealer":
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.check_once()
                except Exception:  # noqa: BLE001 - keep watching
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="mtpu-fresh-disk")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

"""The port's self-healing services against minio_tpu's, on the CPU: the
MRF drain, heal_erasure_set, the disk monitor, the fresh-drive healer,
the update tracker and the data scanner, with the admin usage routes.

Each case of minio_tpu's own tests (tests/test_background_events.py,
tests/test_disk_monitor.py, tests/test_fresh_disk.py,
tests/test_update_tracker.py) runs on both packages. Where a case
compares the packages, both get the same writes on sets of the same
drives, and every file of every drive must compare whole: ids and clocks
are made alike (each package's `uuid` in storage/fileinfo.py is one
seeded sequence, restarted for each side; the object layers' and the
scanners' clock reads a time the test sets before each write). minio_tpu
runs with MTPU_WORKER_POOL=0 and MTPU_CODEC=dense-gf8, both at
BLOCK_SIZE_V2 = 12 * 4096 with MTPU_INLINE_THRESHOLD = 4096 (the port's
plain HighwayHash is a Python loop over 32-byte packets).

Faults of minio_tpu, recorded in ROADMAP Queue 3, are held here: the
port fixes four (an MRF pass during an outage drops the entry; a heal
with remove_dangling deletes an object that pulled drives put under
read quorum; the fresh-drive sweep never makes a bucket's volume, nor
the system bucket's) and copies one (the sweep skips the system
bucket's objects).
"""

import hashlib
import io
import json
import random
import shutil
import threading
import time
import types
import uuid
from pathlib import Path

import pytest
import torch

from minio_tpu.api import S3Server as JaxS3Server
from minio_tpu.background import heal as jax_heal
from minio_tpu.background import monitor as jax_monitor
from minio_tpu.background import newdisk as jax_newdisk
from minio_tpu.background import scanner as jax_scanner
from minio_tpu.background import tracker as jax_tracker
from minio_tpu.bucket import BucketMetadataSys as JaxBucketMetadataSys
from minio_tpu.iam import IAMSys as JaxIAMSys
from minio_tpu.object import erasure_objects as jax_eo
from minio_tpu.object.pools import ErasureServerPools as JaxPools
from minio_tpu.object.sets import ErasureSets as JaxSets
from minio_tpu.object.sets import read_format as jax_read_format
from minio_tpu.object.types import ObjectOptions as JaxOptions
from minio_tpu.storage import fileinfo as jax_fileinfo
from minio_tpu.storage.local import LocalStorage as JaxLocal
from minio_tpu.utils import fanout as jax_fanout
from minio_tpu.utils.errors import ErrUnformattedDisk as JaxUnformatted
from minio_tpu_torch.api.client import S3Client
from minio_tpu_torch.api.server import S3Server
from minio_tpu_torch.background import heal, monitor, newdisk, scanner, tracker
from minio_tpu_torch.bucket.metadata import BucketMetadataSys
from minio_tpu_torch.iam.store import IAMSys
from minio_tpu_torch.object import erasure_objects
from minio_tpu_torch.object.pools import ErasureServerPools
from minio_tpu_torch.object.sets import ErasureSets, read_format
from minio_tpu_torch.object.types import ObjectOptions
from minio_tpu_torch.storage import fileinfo
from minio_tpu_torch.storage.local import LocalStorage
from minio_tpu_torch.utils import fanout
from minio_tpu_torch.utils.errors import (ErrErasureReadQuorum,
                                        ErrUnformattedDisk)

torch.set_num_threads(1)

PORT, JAX = "port", "jax"
PKGS = (PORT, JAX)
DEP = "fdfdfdfd-1111-2222-3333-fdfdfdfdfdfd"
T0 = 1_700_000_000_123_456_789
SMALL_BLOCK = 12 * 4096
ACCESS, SECRET = "bgadmin", "bgadmin-secret-key"

# Each package's pieces, by name.
MODS = {
    PORT: types.SimpleNamespace(
        Local=LocalStorage, Sets=ErasureSets, Pools=ErasureServerPools,
        Options=ObjectOptions, heal=heal, monitor=monitor, newdisk=newdisk,
        scanner=scanner, tracker=tracker, read_format=read_format,
        Unformatted=ErrUnformattedDisk, kw={"device": "cpu"}),
    JAX: types.SimpleNamespace(
        Local=JaxLocal, Sets=JaxSets, Pools=JaxPools, Options=JaxOptions,
        heal=jax_heal, monitor=jax_monitor, newdisk=jax_newdisk,
        scanner=jax_scanner, tracker=jax_tracker,
        read_format=jax_read_format, Unformatted=JaxUnformatted, kw={}),
}


class _Shim(types.SimpleNamespace):
    """A module stand-in: its own attributes, the rest from `base`."""

    def __init__(self, base, **attrs):
        super().__init__(**attrs)
        self._base = base

    def __getattr__(self, name):
        return getattr(self._base, name)


class _Clock:
    """The wall clock the test sets; monotonic clocks stay real."""

    def __init__(self):
        self.now = T0

    def time_ns(self) -> int:
        return self.now


@pytest.fixture
def env(monkeypatch):
    """Both packages at small blocks with part files, dense-gf8, no
    worker pool."""
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "4096")
    monkeypatch.setattr(jax_eo, "BLOCK_SIZE_V2", SMALL_BLOCK)
    monkeypatch.setattr(erasure_objects, "BLOCK_SIZE_V2", SMALL_BLOCK)


@pytest.fixture
def alike(env, monkeypatch):
    """Seeded ids and a set clock for both packages. Returns (clock,
    restart): restart() rewinds the ids and the clock for the next
    side."""
    rng = [random.Random(7)]
    seeded = _Shim(uuid, uuid4=lambda: uuid.UUID(
        int=rng[0].getrandbits(128), version=4))
    for mod in (fileinfo, jax_fileinfo):
        monkeypatch.setattr(mod, "uuid", seeded)
    clock = _Clock()
    shim = _Shim(time, time_ns=clock.time_ns)
    for mod in (erasure_objects, jax_eo, scanner, jax_scanner):
        monkeypatch.setattr(mod, "time", shim)

    def restart():
        rng[0] = random.Random(7)
        clock.now = T0

    return clock, restart


def _layer(pkg, root: Path, n: int = 4, parity=None, prefix: str = "d"):
    """(disks, sets, object layer) over n fresh drives d0.. under root."""
    m = MODS[pkg]
    disks = [m.Local(str(root / f"{prefix}{i}"), endpoint=f"{prefix}{i}",
                     **m.kw) for i in range(n)]
    sets = m.Sets(disks, n, deployment_id=DEP, pool_index=0,
                  default_parity=parity, **m.kw)
    sets.init_format()
    return disks, sets, m.Pools([sets], **m.kw)


def _reopen(pkg, root: Path, n: int = 4, parity=None):
    """The drives under root, written by either package, opened by pkg."""
    m = MODS[pkg]
    disks = [m.Local(str(root / f"d{i}"), endpoint=f"d{i}", **m.kw)
             for i in range(n)]
    sets = m.Sets(disks, n, deployment_id=DEP, pool_index=0,
                  default_parity=parity, **m.kw)
    sets.load_format()
    return disks, sets, m.Pools([sets], **m.kw)


def _wipe(pkg, root: Path, disks, idx: int):
    """A replaced drive: an empty directory at the same mount point."""
    shutil.rmtree(str(root / f"d{idx}"))
    disks[idx].__init__(str(root / f"d{idx}"), endpoint=f"d{idx}",
                        **MODS[pkg].kw)


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _drive(root: Path, idx: int, skip=(".mtpu.sys/tmp",)) -> dict:
    return {k: v for k, v in _tree(root / f"d{idx}").items()
            if not k.startswith(skip)}


def _body(name: str, size: int) -> bytes:
    seed = hashlib.sha256(name.encode()).digest()
    return (seed * (size // 32 + 1))[:size]


def _put(ol, pkg, bucket, name, size, clock=None, versioned=False):
    if clock is not None:
        clock.now += 10 ** 9
    ol.put_object(bucket, name, io.BytesIO(_body(name, size)), size,
                  MODS[pkg].Options(versioned=versioned))


# ---------------------------------------------------------------------------
# the MRF drain (tests/test_background_events.py, and the queue times)


@pytest.mark.parametrize("pkg", PKGS)
def test_mrf_drain_heals_partial_writes(env, tmp_path, pkg):
    _, sets, ol = _layer(pkg, tmp_path)
    ol.make_bucket("mrfbkt")
    data = b"m" * 100000
    ol.put_object("mrfbkt", "part.bin", io.BytesIO(data), len(data))
    es = sets.sets[0]
    es.queue_mrf("mrfbkt", "part.bin", "")
    healer = MODS[pkg].heal.MRFHealer(ol)
    assert healer.drain_once() == 1
    assert es.drain_mrf() == []


def test_mrf_partial_write_queues_and_heals_alike(alike, tmp_path):
    """A PUT with a drive offline queues the same entry in both packages,
    and drain_once heals it onto the returned drive: every file of both
    sets equal."""
    clock, restart = alike
    queued, trees = {}, {}
    for pkg in PKGS:
        restart()
        root = tmp_path / pkg
        disks, sets, ol = _layer(pkg, root)
        ol.make_bucket("mrf")
        disks[1].set_online(False)
        _put(ol, pkg, "mrf", "partial", 20_000, clock)
        _put(ol, pkg, "mrf", "inline", 900, clock)
        es = sets.sets[0]
        with es._mrf_lock:
            queued[pkg] = list(es._mrf)
        disks[1].set_online(True)
        assert MODS[pkg].heal.MRFHealer(ol).drain_once() == 2
        assert es.drain_mrf() == []
        assert ol.get_object_bytes("mrf", "partial") == _body("partial",
                                                              20_000)
        trees[pkg] = _tree(root)
    assert queued[PORT] == queued[JAX] == [("mrf", "partial", ""),
                                           ("mrf", "inline", "")]
    assert trees[PORT] == trees[JAX]
    assert any(k.startswith("d1/mrf/partial/") for k in trees[PORT])


@pytest.mark.parametrize("pkg", PKGS)
def test_mrf_failing_heal_requeued_with_first_time(env, tmp_path, pkg):
    _, sets, ol = _layer(pkg, tmp_path)
    ol.make_bucket("mrf")
    es = sets.sets[0]
    t0 = time.monotonic() - 50.0
    es.queue_mrf("mrf", "stuck", "v1", enqueued_at=t0)

    def failing(*a, **kw):
        raise RuntimeError("drive error")

    es.heal_object = failing
    healer = MODS[pkg].heal.MRFHealer(ol)
    assert healer.drain_once() == 0
    stats = es.mrf_stats()
    assert stats["pending"] == 1 and stats["oldest_age_s"] >= 50.0
    assert es.drain_mrf(with_times=True) == [("mrf", "stuck", "v1", t0)]


@pytest.mark.parametrize("pkg", PKGS)
def test_mrf_not_found_entry_dropped(env, tmp_path, pkg):
    _, sets, ol = _layer(pkg, tmp_path)
    ol.make_bucket("mrf")
    es = sets.sets[0]
    es.queue_mrf("mrf", "never-written")
    healer = MODS[pkg].heal.MRFHealer(ol)
    assert healer.drain_once() == 0
    assert es.mrf_stats() == {"pending": 0, "oldest_age_s": 0.0}


@pytest.mark.parametrize("pkg", PKGS)
def test_mrf_drain_rate_floored_at_the_interval(env, tmp_path, pkg):
    _, sets, ol = _layer(pkg, tmp_path)
    ol.make_bucket("mrf")
    for i in range(3):
        _put(ol, pkg, "mrf", f"o{i}", 100)
        sets.sets[0].queue_mrf("mrf", f"o{i}")
    healer = MODS[pkg].heal.MRFHealer(ol)
    assert healer.drain_rate_per_s() == 0.0
    assert healer.drain_once() == 3
    # One fresh sample reads as 3 an interval (5 s), not 3 over the
    # microseconds since the pass.
    assert healer.drain_rate_per_s() == pytest.approx(3 / 5.0, rel=1e-3)
    assert healer.healed_total == 3


@pytest.mark.parametrize("pkg", PKGS)
def test_mrf_pass_during_an_outage(env, tmp_path, pkg):
    """minio_tpu's fault, fixed in the port: an MRF pass that runs while
    the disk monitor has pulled a drive heals nothing onto it; minio_tpu
    drops the entry then, so the reconnect drain finds the queue empty
    and the drive never gets the write. The port keeps the entry, with
    its first time, until the reconnect drain heals it."""
    disks, sets, ol = _layer(pkg, tmp_path)
    ol.make_bucket("mon")
    es = sets.sets[0]
    mrf = MODS[pkg].heal.MRFHealer(ol)
    mon = MODS[pkg].monitor.DiskMonitor(ol, mrf_healer=mrf)
    disks[2].set_online(False)
    mon.check_once()
    assert mon.check_once()["offline"] == ["d2"]
    _put(ol, pkg, "mon", "during", 20_000)
    assert es.mrf_stats()["pending"] == 1
    mrf.drain_once()  # the 5 s loop's pass, the drive still out
    assert es.mrf_stats()["pending"] == (1 if pkg == PORT else 0)
    disks[2].set_online(True)
    assert mon.check_once()["reconnected"] == ["d2"]
    assert es.mrf_stats()["pending"] == 0
    landed = (tmp_path / "d2" / "mon" / "during" / "xl.meta").is_file()
    if pkg == PORT:
        assert landed and mrf.healed_total == 1
    else:
        assert not landed and mrf.healed_total == 1  # healed "nothing"


@pytest.mark.parametrize("pkg", PKGS)
def test_mrf_keys_held_once_while_a_drive_is_pulled(env, tmp_path, pkg):
    """The port's drain heals a key queued three times once, with its
    first time; while a drive of the set is pulled it heals nothing and
    holds the key for the reconnect drain. minio_tpu heals every copy on
    every pass and drops them."""
    _, sets, ol = _layer(pkg, tmp_path)
    ol.make_bucket("mrf")
    _put(ol, pkg, "mrf", "o", 20_000)
    es = sets.sets[0]
    t0 = time.monotonic() - 30.0
    for dt in (5.0, 0.0, 9.0):
        es.queue_mrf("mrf", "o", "", enqueued_at=t0 + dt)
    calls = []
    real = es.heal_object
    es.heal_object = lambda *a, **kw: calls.append(a) or real(*a, **kw)
    mrf = MODS[pkg].heal.MRFHealer(ol)
    pulled, es.disks[2] = es.disks[2], None  # as the monitor pulls it
    mrf.drain_once()
    mrf.drain_once()
    if pkg == PORT:
        assert calls == []
        assert es.drain_mrf(with_times=True) == [("mrf", "o", "", t0)]
        for dt in (5.0, 0.0):
            es.queue_mrf("mrf", "o", "", enqueued_at=t0 + dt)
    else:
        assert len(calls) == 3 and es.mrf_stats()["pending"] == 0
    es.disks[2] = pulled
    calls.clear()
    assert mrf.drain_once() == (1 if pkg == PORT else 0)
    assert len(calls) == (1 if pkg == PORT else 0)
    assert es.mrf_stats()["pending"] == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_mrf_pass_with_parity_plus_one_drives_pulled(env, tmp_path, pkg):
    """minio_tpu's fault, fixed in the port: a PUT with one drive of a
    6+2 set pulled queues MRF; two more drives are pulled, parity + 1 in
    all, and a drain pass runs. minio_tpu's heal counts the pulled
    drives as missing shards, calls the object dangling and deletes it
    from the five drives that are up, so it is lost once the drives
    return. The port holds the entry, and its heal calls a version
    dangling only when more than parity drives answer that it is gone:
    after the reconnect the object reads back whole from every drive."""
    disks, sets, ol = _layer(pkg, tmp_path, n=8, parity=2, prefix="p")
    ol.make_bucket("out")
    es = sets.sets[0]
    mrf = MODS[pkg].heal.MRFHealer(ol)
    mon = MODS[pkg].monitor.DiskMonitor(ol, mrf_healer=mrf,
                                        fail_threshold=1)
    disks[1].set_online(False)
    assert mon.check_once()["offline"] == ["p1"]
    body = _body("kept", 60_000)
    ol.put_object("out", "kept", io.BytesIO(body), len(body))
    assert es.mrf_stats()["pending"] == 1
    disks[3].set_online(False)
    disks[6].set_online(False)
    assert sorted(mon.check_once()["offline"]) == ["p3", "p6"]
    mrf.drain_once()  # the 5 s loop's pass during the outage
    for i in (1, 3, 6):
        disks[i].set_online(True)
    assert sorted(mon.check_once()["reconnected"]) == ["p1", "p3", "p6"]
    assert es.mrf_stats()["pending"] == 0
    if pkg == PORT:
        assert ol.get_object_bytes("out", "kept") == body
        assert all(d.read_version("out", "kept") for d in es.disks)
    else:
        with pytest.raises(Exception):
            ol.get_object_bytes("out", "kept")


@pytest.mark.parametrize("pkg", PKGS)
def test_heal_with_remove_dangling_while_drives_are_pulled(env, tmp_path,
                                                           pkg):
    """A heal with remove_dangling while parity + 1 drives of a 6+2 set
    are pulled: minio_tpu deletes the object from the five drives that
    are up; the port raises the read-quorum error and deletes nothing,
    so the object reads back once the drives return."""
    _, sets, ol = _layer(pkg, tmp_path, n=8, parity=2, prefix="p")
    ol.make_bucket("out")
    body = _body("kept", 60_000)
    ol.put_object("out", "kept", io.BytesIO(body), len(body))
    es = sets.sets[0]
    saved = list(es.disks)
    for i in (1, 3, 6):
        es.disks[i] = None
    if pkg == PORT:
        with pytest.raises(ErrErasureReadQuorum):
            es.heal_object("out", "kept", remove_dangling=True)
    else:
        assert es.heal_object("out", "kept",
                              remove_dangling=True)["dangling"]
    es.disks[:] = saved
    if pkg == PORT:
        assert ol.get_object_bytes("out", "kept") == body
    else:
        with pytest.raises(Exception):
            ol.get_object_bytes("out", "kept")


@pytest.mark.parametrize("pkg", PKGS)
def test_heal_removes_a_dangling_object(env, tmp_path, pkg):
    """tests/test_object_layer.py::test_heal_dangling_object: with three
    of four drives answering that the object is gone, the heal raises
    without remove_dangling and purges the last shard with it."""
    disks, _, ol = _layer(pkg, tmp_path)
    ol.make_bucket("bkt")
    body = _body("dang", 60_000)
    ol.put_object("bkt", "dang", io.BytesIO(body), len(body))
    for i in (0, 1, 2):
        shutil.rmtree(tmp_path / f"d{i}" / "bkt" / "dang")
    with pytest.raises(Exception, match="shards available"):
        ol.heal_object("bkt", "dang")
    assert ol.heal_object("bkt", "dang", remove_dangling=True)["dangling"]
    assert not (tmp_path / "d3" / "bkt" / "dang").exists()


@pytest.mark.parametrize("single_core", [True, False])
def test_heal_erasure_set_under_both_drivers(alike, tmp_path, monkeypatch,
                                             single_core):
    clock, restart = alike
    monkeypatch.setattr(fanout, "SINGLE_CORE", single_core)
    monkeypatch.setattr(jax_fanout, "SINGLE_CORE", single_core)
    results, trees = {}, {}
    for pkg in PKGS:
        restart()
        root = tmp_path / pkg
        _, sets, ol = _layer(pkg, root)
        ol.make_bucket("sweep")
        for i, size in enumerate((100_000, 700, 20_000)):
            _put(ol, pkg, "sweep", f"obj-{i}", size, clock)
        shutil.rmtree(root / "d0" / "sweep")
        results[pkg] = MODS[pkg].heal.heal_erasure_set(ol)
        trees[pkg] = _tree(root)
    assert results[PORT] == results[JAX] == {"buckets": 1, "objects": 3,
                                             "failed": 0}
    assert trees[PORT] == trees[JAX]
    assert any(k.startswith("d0/sweep/obj-0/") for k in trees[PORT])


# ---------------------------------------------------------------------------
# the disk monitor (tests/test_disk_monitor.py; the REST case waits for
# the distributed plane)


@pytest.mark.parametrize("pkg", PKGS)
def test_local_disk_offline_and_reconnect(env, tmp_path, pkg):
    disks, sets, ol = _layer(pkg, tmp_path)
    ol.make_bucket("mon")
    m = MODS[pkg]
    mrf = m.heal.MRFHealer(ol)
    mon = m.monitor.DiskMonitor(ol, mrf_healer=mrf)
    assert mon.check_once() == {"offline": [], "reconnected": []}
    disks[2].set_online(False)
    assert mon.check_once()["offline"] == []
    assert mon.check_once()["offline"] == ["d2"]
    es = sets.sets[0]
    assert es.disks.count(None) == 1
    body = b"written while degraded" * 1000
    ol.put_object("mon", "degraded.bin", io.BytesIO(body), len(body))
    assert ol.get_object_bytes("mon", "degraded.bin") == body
    with es._mrf_lock:
        assert len(es._mrf) >= 1
    disks[2].set_online(True)
    assert mon.check_once()["reconnected"] == ["d2"]
    assert es.disks.count(None) == 0
    with es._mrf_lock:
        assert es._mrf == []
    ok = 0
    for d in es.disks:
        try:
            d.read_version("mon", "degraded.bin")
            ok += 1
        except Exception:  # noqa: BLE001 - a drive without the version
            continue
    assert ok == 4


def test_six_disk_outage_write_then_auto_heal(alike, tmp_path):
    """Writes during a two-drive outage of a 4+2 set land in the MRF and
    heal onto the returned drives within one monitor sweep, alike in
    both packages: every file of both sets equal."""
    clock, restart = alike
    trees = {}
    for pkg in PKGS:
        restart()
        root = tmp_path / pkg
        disks, sets, ol = _layer(pkg, root, n=6, parity=2, prefix="w")
        ol.make_bucket("mon")
        es = sets.sets[0]
        mon = MODS[pkg].monitor.DiskMonitor(
            ol, mrf_healer=MODS[pkg].heal.MRFHealer(ol))
        disks[1].set_online(False)
        disks[4].set_online(False)
        mon.check_once()
        assert len(mon.check_once()["offline"]) == 2
        clock.now += 10 ** 9
        body = b"outage write" * 5000
        ol.put_object("mon", "heal-me.bin", io.BytesIO(body), len(body))
        disks[1].set_online(True)
        disks[4].set_online(True)
        assert len(mon.check_once()["reconnected"]) == 2
        with es._mrf_lock:
            assert es._mrf == []
        assert sum(1 for d in es.disks
                   if d.read_version("mon", "heal-me.bin")) == 6
        assert ol.get_object_bytes("mon", "heal-me.bin") == body
        trees[pkg] = _tree(root)
    assert trees[PORT] == trees[JAX]


@pytest.mark.parametrize("pkg", PKGS)
def test_zombie_probe_evicted_and_disk_readmitted(env, tmp_path, monkeypatch,
                                                  pkg):
    mon_mod = MODS[pkg].monitor
    monkeypatch.setattr(mon_mod, "PROBE_TIMEOUT_S", 0.05)
    monkeypatch.setattr(mon_mod, "PROBE_PENDING_MAX_AGE_S", 0.2)
    disks, sets, ol = _layer(pkg, tmp_path, prefix="z")
    es = sets.sets[0]
    release = threading.Event()
    state = {"hang": True}

    class WedgedPing:
        """ping() wedges (not merely fails) while state['hang']."""

        def __init__(self, inner):
            self._inner = inner

        def ping(self):
            if state["hang"]:
                release.wait(30)
                raise RuntimeError("zombie probe finally unwedged")

        def __getattr__(self, name):
            return getattr(self._inner, name)

    es.disks[2] = WedgedPing(disks[2])
    mon = mon_mod.DiskMonitor(ol, fail_threshold=1)
    try:
        mon.check_once(wait=False)
        time.sleep(0.1)
        assert mon.check_once(wait=False)["offline"] == ["z2"]
        state["hang"] = False
        time.sleep(0.15)
        reconnected = []
        for _ in range(3):
            reconnected += mon.check_once(wait=True)["reconnected"]
            if reconnected:
                break
        assert reconnected == ["z2"]
        assert es.disks.count(None) == 0
    finally:
        release.set()


# ---------------------------------------------------------------------------
# the fresh-drive healer (tests/test_fresh_disk.py)


def _put_many(ol, pkg, n=12, size=16 * 1024):
    for i in range(n):
        body = bytes([i % 251]) * size
        ol.put_object("fresh", f"obj/{i:03d}", io.BytesIO(body), size)


@pytest.mark.parametrize("pkg", PKGS)
def test_fresh_disk_detected_formatted_and_healed(env, tmp_path, pkg):
    m = MODS[pkg]
    disks, sets, ol = _layer(pkg, tmp_path)
    ol.make_bucket("fresh")
    _put_many(ol, pkg)
    before = _drive(tmp_path, 2)
    _wipe(pkg, tmp_path, disks, 2)
    with pytest.raises(m.Unformatted):
        m.read_format(disks[2])
    healer = m.newdisk.FreshDiskHealer(ol)
    assert healer.check_once() == ["d2"]
    doc = m.read_format(disks[2])
    assert doc["id"] == DEP and doc["xl"]["this"] == "disk-0-2"
    # The healed drive really holds its shards again: every file back.
    assert _drive(tmp_path, 2) == before
    disks[0].set_online(False)
    for i in range(12):
        assert ol.get_object_bytes("fresh", f"obj/{i:03d}") == \
            bytes([i % 251]) * 16 * 1024
    assert m.newdisk.HealingTracker.load(disks[2]) is None


@pytest.mark.parametrize("pkg", PKGS)
def test_interrupted_heal_resumes(env, tmp_path, pkg):
    m = MODS[pkg]
    disks, sets, ol = _layer(pkg, tmp_path)
    ol.make_bucket("fresh")
    _put_many(ol, pkg, n=8)
    _wipe(pkg, tmp_path, disks, 1)
    healer = m.newdisk.FreshDiskHealer(ol, checkpoint_every=2)
    calls = {"n": 0}
    real_heal = ol.heal_object

    def crashing(bucket, obj, **kw):
        calls["n"] += 1
        if calls["n"] > 3:
            raise KeyboardInterrupt  # not swallowed by the sweep
        return real_heal(bucket, obj, **kw)

    ol.heal_object = crashing
    with pytest.raises(KeyboardInterrupt):
        healer.check_once()
    ol.heal_object = real_heal
    t = m.newdisk.HealingTracker.load(disks[1])
    assert t is not None and not t.finished
    assert t.objects_healed >= 2 and t.last_object
    assert m.newdisk.FreshDiskHealer(ol).check_once() == ["d1"]
    assert m.newdisk.HealingTracker.load(disks[1]) is None
    for i in range(8):
        assert len(ol.get_object_bytes("fresh", f"obj/{i:03d}")) == 16 * 1024


@pytest.mark.parametrize("pkg", PKGS)
def test_no_false_positives(env, tmp_path, pkg):
    _, _, ol = _layer(pkg, tmp_path)
    ol.make_bucket("fresh")
    _put_many(ol, pkg, n=3)
    assert MODS[pkg].newdisk.FreshDiskHealer(ol).check_once() == []


@pytest.mark.parametrize("pkg", PKGS)
def test_page_split_key_versions_all_healed(env, tmp_path, pkg):
    m = MODS[pkg]
    disks, sets, ol = _layer(pkg, tmp_path)
    ol.make_bucket("fresh")
    for i in range(5):
        body = bytes([i]) * 4096
        ol.put_object("fresh", "multi", io.BytesIO(body), len(body),
                      m.Options(versioned=True))
    for k in ("aaa", "zzz"):
        ol.put_object("fresh", k, io.BytesIO(b"n"), 1,
                      m.Options(versioned=True))
    _wipe(pkg, tmp_path, disks, 0)
    healer = m.newdisk.FreshDiskHealer(ol)
    healer.page_size = 2
    assert healer.check_once() == ["d0"]
    disks[3]._online = False
    try:
        vers = [v for v in
                ol.list_object_versions("fresh", prefix="multi").versions
                if v.name == "multi"]
        assert len(vers) == 5
        for v in vers:
            sink = io.BytesIO()
            ol.get_object("fresh", "multi", sink,
                          opts=m.Options(version_id=v.version_id))
            assert len(sink.getvalue()) == 4096
    finally:
        disks[3]._online = True


@pytest.mark.parametrize("pkg", PKGS)
def test_sweep_heals_every_version_of_a_split_key(env, tmp_path, pkg):
    """minio_tpu's fault, fixed in the port: once the sweep has healed the
    first versions of a key whose versions straddle a listing page, the
    next page reads the key's journal from the healing drive (the first
    drive that has it), which holds only those versions, so the rest are
    never listed or healed. The port heals a split key's versions once
    all are listed, and the drive gets all of them back."""
    m = MODS[pkg]
    disks, _, ol = _layer(pkg, tmp_path)
    ol.make_bucket("fresh")
    ol.put_object("fresh", "aaa", io.BytesIO(b"a" * 20_000), 20_000)
    for i in range(5):
        ol.put_object("fresh", "multi", io.BytesIO(bytes([i]) * 20_000),
                      20_000, m.Options(versioned=True))
    _wipe(pkg, tmp_path, disks, 0)
    healer = m.newdisk.FreshDiskHealer(ol)
    healer.page_size = 2
    assert healer.check_once() == ["d0"]
    parts = list((tmp_path / "d0" / "fresh" / "multi").glob("*/part.1"))
    assert len(parts) == (5 if pkg == PORT else 1)


@pytest.mark.parametrize("pkg", PKGS)
def test_system_meta_bucket_healed(env, tmp_path, pkg):
    """minio_tpu's case: the system bucket's object reads back with
    another drive lost (at 2+2 it would without the heal). Its fault,
    copied: list_buckets lists user buckets only, so the sweep never
    reaches .minio.sys and the healed drive has no copy of the object."""
    m = MODS[pkg]
    disks, sets, ol = _layer(pkg, tmp_path)
    ol.make_bucket(".minio.sys")
    body = b'{"config": "precious"}'
    ol.put_object(".minio.sys", "config/blob.json", io.BytesIO(body),
                  len(body))
    _wipe(pkg, tmp_path, disks, 2)
    assert m.newdisk.FreshDiskHealer(ol).check_once() == ["d2"]
    assert not (tmp_path / "d2" / ".minio.sys" / "config").exists()
    disks[0]._online = False
    try:
        assert ol.get_object_bytes(".minio.sys", "config/blob.json") == body
    finally:
        disks[0]._online = True


@pytest.mark.parametrize("pkg", PKGS)
def test_system_writes_reach_a_healed_drive(env, tmp_path, pkg):
    """minio_tpu's fault, fixed in the port: its sweep never makes the
    system bucket's volume on the fresh drive, so every later write into
    .minio.sys (the scanner's usage, each cycle) misses that drive and
    queues an MRF heal, which cannot make the volume either. The port
    makes the volume when it sweeps, as MinIO makes the meta volumes on a
    drive it formats: the write lands on all four drives."""
    m = MODS[pkg]
    disks, sets, ol = _layer(pkg, tmp_path)
    ol.make_bucket(".minio.sys")
    _wipe(pkg, tmp_path, disks, 2)
    assert m.newdisk.FreshDiskHealer(ol).check_once() == ["d2"]
    es = sets.sets[0]
    body = b'{"usage": 1}'
    for _ in range(2):
        ol.put_object(".minio.sys", "scanner/data-usage.json",
                      io.BytesIO(body), len(body))
    meta = tmp_path / "d2" / ".minio.sys" / "scanner" / "data-usage.json"
    if pkg == PORT:
        assert (meta / "xl.meta").is_file()
        assert es.mrf_stats()["pending"] == 0
    else:
        assert not (tmp_path / "d2" / ".minio.sys").exists()
        assert es.drain_mrf() == [(".minio.sys", "scanner/data-usage.json",
                                   "")] * 2
        es.heal_object(".minio.sys", "scanner/data-usage.json")
        assert not (tmp_path / "d2" / ".minio.sys").exists()
    assert ol.get_object_bytes(".minio.sys",
                               "scanner/data-usage.json") == body


def _fresh_set(pkg, ol, clock):
    """A bucket whose first key has part files (so minio_tpu's sweep makes
    the bucket's directory before it needs it), an inline object, and a
    versioned key of two versions under a delete marker."""
    ol.make_bucket("fresh")
    _put(ol, pkg, "fresh", "a-big", 30_000, clock)
    _put(ol, pkg, "fresh", "b-small", 1000, clock)
    for size in (20_000, 25_000):
        _put(ol, pkg, "fresh", "c-ver", size, clock, versioned=True)
    clock.now += 10 ** 9
    ol.delete_object("fresh", "c-ver", MODS[pkg].Options(versioned=True))


def test_fresh_drive_healed_alike(alike, tmp_path):
    """Both packages heal a wiped drive to the same files. Every file of
    the drive is back as it was but the versioned key's xl.meta: a heal
    writes each version's is-latest flag as it reads it, and the delete
    marker's erasure stamp from the version it copies (minio_tpu's
    heal_object, copied; its versions are the same)."""
    clock, restart = alike
    trees, healed = {}, {}
    for pkg in PKGS:
        restart()
        root = tmp_path / pkg
        disks, _, ol = _layer(pkg, root)
        _fresh_set(pkg, ol, clock)
        before = _drive(root, 1)
        _wipe(pkg, root, disks, 1)
        assert MODS[pkg].newdisk.FreshDiskHealer(ol).check_once() == ["d1"]
        after = _drive(root, 1)
        healed[pkg] = after
        assert set(after) == set(before)
        assert [p for p in before if after[p] != before[p]] == \
            ["fresh/c-ver/xl.meta"]
        trees[pkg] = _tree(root)
    assert trees[PORT] == trees[JAX]


@pytest.mark.parametrize("writer,healer", [(PORT, JAX), (JAX, PORT)])
def test_each_package_heals_the_others_drives(alike, tmp_path, writer,
                                              healer):
    clock, restart = alike
    restart()
    root = tmp_path / "drives"
    _, _, ol = _layer(writer, root)
    _fresh_set(writer, ol, clock)
    before = _drive(root, 3)
    disks, _, ol = _reopen(healer, root)
    _wipe(healer, root, disks, 3)
    assert MODS[healer].newdisk.FreshDiskHealer(ol).check_once() == ["d3"]
    after = _drive(root, 3)
    assert set(after) == set(before)
    assert [p for p in before if after[p] != before[p]] == \
        ["fresh/c-ver/xl.meta"]
    _, _, reader = _reopen(writer, root)
    assert reader.get_object_bytes("fresh", "a-big") == _body("a-big",
                                                              30_000)


@pytest.mark.parametrize("pkg", PKGS)
def test_sweep_makes_the_bucket_volume_first(env, tmp_path, pkg):
    """minio_tpu's fault, fixed in the port: its sweep never makes a
    bucket's volume on the fresh drive, so an inline object or a delete
    marker (whose heal writes only xl.meta) is skipped silently until a
    part file's rename makes the directory. The port heals the bucket
    first, as MinIO's healErasureSet does, and gets every file back."""
    m = MODS[pkg]
    disks, _, ol = _layer(pkg, tmp_path)
    ol.make_bucket("inl")
    for name in ("a", "b"):
        ol.put_object("inl", name, io.BytesIO(b"i" * 700), 700)
    before = _tree(tmp_path / "d2" / "inl")
    _wipe(pkg, tmp_path, disks, 2)
    assert m.newdisk.FreshDiskHealer(ol).check_once() == ["d2"]
    after = _tree(tmp_path / "d2" / "inl")
    assert sorted(before) == ["a/xl.meta", "b/xl.meta"]
    assert after == (before if pkg == PORT else {})


# ---------------------------------------------------------------------------
# the update tracker and the scanner (tests/test_update_tracker.py,
# tests/test_background_events.py)


@pytest.mark.parametrize("pkg", PKGS)
def test_bloom_mark_and_membership(pkg):
    t = MODS[pkg].tracker.DataUpdateTracker()
    assert t.changed_since_last_cycle("anything")
    t.advance()
    assert not t.changed_since_last_cycle("quiet-bucket")
    t.mark("busy-bucket", "obj/a")
    assert t.changed_since_last_cycle("busy-bucket")
    assert t.changed_since_last_cycle("busy-bucket", "obj/a")
    assert not t.changed_since_last_cycle("quiet-bucket")
    t.advance()
    assert t.changed_since_last_cycle("busy-bucket")
    t.advance()
    assert not t.changed_since_last_cycle("busy-bucket")


def _tracked(pkg, tmp_path):
    _, _, ol = _layer(pkg, tmp_path)
    t = MODS[pkg].tracker.DataUpdateTracker(ol)
    ol.update_tracker = t
    return ol, t


@pytest.mark.parametrize("pkg", PKGS)
def test_unchanged_bucket_skipped(env, tmp_path, pkg):
    ol, t = _tracked(pkg, tmp_path)
    ol.make_bucket("hot")
    ol.make_bucket("cold")
    for i in range(5):
        _put(ol, pkg, "hot", f"h{i}", 1)
        _put(ol, pkg, "cold", f"c{i}", 1)
    sc = MODS[pkg].scanner.DataScanner(ol, tracker=t)
    sc.scan_cycle()
    assert sc.usage.buckets_usage["cold"].objects_count == 5
    calls = []
    orig = ol.list_objects

    def counting(bucket, *a, **kw):
        calls.append(bucket)
        return orig(bucket, *a, **kw)

    ol.list_objects = counting
    sc.scan_cycle()
    assert [c for c in calls if not c.startswith(".")] == []
    assert sc.buckets_skipped_last_cycle == 2
    calls.clear()
    _put(ol, pkg, "hot", "h-new", 1)
    sc.scan_cycle()
    assert {c for c in calls if not c.startswith(".")} == {"hot"}
    assert sc.usage.buckets_usage["hot"].objects_count == 6
    assert sc.usage.buckets_usage["cold"].objects_count == 5


@pytest.mark.parametrize("pkg", PKGS)
def test_full_pass_every_n_cycles(env, tmp_path, pkg):
    ol, t = _tracked(pkg, tmp_path)
    ol.make_bucket("bkt")
    _put(ol, pkg, "bkt", "a", 1)
    sc = MODS[pkg].scanner.DataScanner(ol, tracker=t)
    sc.FULL_SCAN_CYCLES = 4
    sc.scan_cycle()
    for _ in range(2):
        sc.scan_cycle()
        assert sc.buckets_skipped_last_cycle == 1
    sc.scan_cycle()
    sc.scan_cycle()  # cycles_completed == 4: the full pass
    assert sc.buckets_skipped_last_cycle == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_tracker_persistence_across_restart(env, tmp_path, pkg):
    ol, t = _tracked(pkg, tmp_path)
    ol.make_bucket("persist")
    _put(ol, pkg, "persist", "x", 1)
    t.save()
    t2 = MODS[pkg].tracker.DataUpdateTracker(ol)
    t2.load()
    t2.advance()
    assert t2.changed_since_last_cycle("persist")
    assert not t2.changed_since_last_cycle("never-touched")


@pytest.mark.parametrize("pkg", PKGS)
def test_usage_survives_restart_with_skip(env, tmp_path, pkg):
    ol, t = _tracked(pkg, tmp_path)
    ol.make_bucket("keep")
    for i in range(3):
        _put(ol, pkg, "keep", f"k{i}", 1)
    MODS[pkg].scanner.DataScanner(ol, tracker=t).scan_cycle()
    s2 = MODS[pkg].scanner.DataScanner(ol, tracker=t)
    s2.load_usage()
    assert s2.usage.buckets_usage["keep"].objects_count == 3


@pytest.mark.parametrize("pkg", PKGS)
def test_scanner_usage_and_heal_sampling(env, tmp_path, pkg):
    _, _, ol = _layer(pkg, tmp_path)
    ol.make_bucket("scanbkt")
    for i in range(5):
        data = bytes([i]) * (1000 * (i + 1))
        ol.put_object("scanbkt", f"obj{i}.bin", io.BytesIO(data), len(data))
    sc = MODS[pkg].scanner.DataScanner(ol, heal_prob=2)
    usage = sc.scan_cycle()
    bu = usage.buckets_usage["scanbkt"]
    assert bu.objects_count == 5
    assert bu.objects_size == sum(1000 * (i + 1) for i in range(5))
    assert usage.objects_total_count == 5
    s2 = MODS[pkg].scanner.DataScanner(ol)
    s2.load_usage()
    assert s2.usage.objects_total_count == 5


def test_same_marks_same_bloom_bytes(env, tmp_path):
    """The same marks give the same filter bits, and the saved filter
    (.minio.sys/scanner/update-tracker.json) the same bytes."""
    blobs, bits = {}, {}
    for pkg in PKGS:
        ol, t = _tracked(pkg, tmp_path / pkg)
        for i in range(50):
            t.mark(f"bucket-{i % 7}", f"obj/{i}")
        bits[pkg] = bytes(t._current.bits)
        t.save()
        blobs[pkg] = ol.get_object_bytes(".minio.sys",
                                         "scanner/update-tracker.json")
    assert bits[PORT] == bits[JAX] and any(bits[PORT])
    assert blobs[PORT] == blobs[JAX]


def _scanned(pkg, root, clock):
    """A tracked layer with two buckets of objects of assorted sizes and
    versions, scanned twice (the heal sample every third object)."""
    ol, t = _tracked(pkg, root)
    ol.make_bucket("sizes")
    ol.make_bucket("vers")
    for i, size in enumerate((0, 1, 700, 5000, 60_000, 100_000)):
        _put(ol, pkg, "sizes", f"s{i}", size, clock)
    for n in range(3):
        _put(ol, pkg, "vers", "doc", 100 + n, clock, versioned=True)
    sc = MODS[pkg].scanner.DataScanner(ol, heal_prob=3, tracker=t)
    sc.sleeper = MODS[pkg].scanner.DynamicSleeper(factor=0.0)
    for _ in range(2):
        clock.now += 10 ** 9
        sc.scan_cycle()
    return ol, sc


def test_usage_snapshots_alike(alike, tmp_path):
    """DataUsageInfo.to_dict() and the saved usage object equal
    minio_tpu's, and so does every file of both sets after the cycles."""
    clock, restart = alike
    dicts, trees = {}, {}
    for pkg in PKGS:
        restart()
        _, sc = _scanned(pkg, tmp_path / pkg, clock)
        dicts[pkg] = sc.usage.to_dict()
        back = MODS[pkg].scanner.DataUsageInfo.from_dict(
            json.loads(json.dumps(dicts[pkg])))
        assert back.to_dict() == dicts[pkg]
        trees[pkg] = _tree(tmp_path / pkg)
    assert dicts[PORT] == dicts[JAX]
    assert dicts[PORT]["bucketsUsage"]["sizes"]["objects_count"] == 6
    assert trees[PORT] == trees[JAX]


def _admin_get(c: S3Client, route: str, query=None):
    status, _, body = c.request("GET", f"/minio/admin/v3/{route}", query)
    return status, json.loads(body) if body else None


_PROGRESS_CLOCKED = ("objectsPerSecond", "etaSeconds", "elapsedSeconds",
                     "lastCycleDurationSeconds")


def test_admin_usage_routes_alike(alike, tmp_path):
    """GET /minio/admin/v3/datausage and /usage[?histogram=true] answer
    minio_tpu's JSON (timestamps and the cycle's timings aside), and
    usage answers 503 without a scanner in both."""
    clock, restart = alike
    answers = {}
    for pkg in PKGS:
        restart()
        ol, sc = _scanned(pkg, tmp_path / pkg, clock)
        if pkg == PORT:
            srv = S3Server(ol, IAMSys(ACCESS, SECRET), BucketMetadataSys(ol),
                           device="cpu").start()
            set_scanner = lambda s: setattr(srv.admin, "scanner", s)  # noqa
        else:
            srv = JaxS3Server(ol, JaxIAMSys(ACCESS, SECRET),
                              JaxBucketMetadataSys(ol)).start()
            set_scanner = lambda s: setattr(  # noqa: E731
                srv.admin, "collector", types.SimpleNamespace(scanner=s))
        try:
            c = S3Client(srv.endpoint, ACCESS, SECRET)
            got = [_admin_get(c, "usage")]
            set_scanner(sc)
            got += [_admin_get(c, "datausage"), _admin_get(c, "usage"),
                    _admin_get(c, "usage", [("histogram", "true")])]
        finally:
            srv.stop()
        for status, doc in got[1:]:
            assert status == 200
            doc.pop("lastUpdate", None)
            for key in _PROGRESS_CLOCKED:
                doc.get("scanner", {}).pop(key, None)
        answers[pkg] = got
    assert answers[PORT] == answers[JAX]
    assert answers[PORT][0] == (503, {"error": "scanner not running"})
    walk, hist = answers[PORT][1][1], answers[PORT][3][1]
    assert walk["bucketsUsage"]["sizes"] == {"objectsCount": 6,
                                             "size": 165_701}
    assert sum(hist["bucketsUsage"]["vers"]["versionsHistogram"].values()) \
        == 1


# ---------------------------------------------------------------------------
# the server and the smoke's phase 4j, on the CPU


def test_server_runs_the_services(tmp_path):
    from minio_tpu_torch.server import Server

    server = Server([str(tmp_path / "d{1...4}")], port=0, device="cpu")
    assert server.object_layer.update_tracker is server.update_tracker
    assert server.disk_monitor.mrf is server.mrf
    server.start()
    threads = [server.mrf._thread, server.disk_monitor._thread,
               server.fresh_disk_healer._thread, server.scanner._thread]
    try:
        assert all(t.is_alive() for t in threads)
        c = S3Client(server.endpoint, "minioadmin", "minioadmin")
        status, doc = _admin_get(c, "usage")
        assert status == 200 and doc["scanner"]["cycle"] == 0
        assert c.request("GET", "/minio/admin/v3/info")[0] == 501
    finally:
        server.stop()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)


def test_self_heal_rehearsal(tmp_path, monkeypatch):
    """entry.self_heal (phase 4j of chip_smoke.py) end to end on the CPU
    at small sizes: a server's own loops drain the MRF after an outage
    and sweep a replaced drive; every check holds."""
    from minio_tpu_torch import entry

    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "1024")
    monkeypatch.setattr(erasure_objects, "BLOCK_SIZE_V2", 12 * 1024)
    res = entry.self_heal(tmp_path, 30_001, device="cpu", big_count=2,
                          msr_count=1, small_count=8,
                          small_sizes=(100, 1025, 3000, 700))
    assert all(res["checks"].values()), (res["checks"], res["sweep"])
    assert res["sweep"]["versions_healed"] == 2 + 1 + 8 + 2 + 3
    assert res["sweep"]["pacer_grants"] == res["sweep"]["versions_healed"]
    for name in ("mrf_drain", "sweep"):
        c = res["counters"][name]
        assert c["launches_gf"] > 0 and c["launches_hash"] > 0, name

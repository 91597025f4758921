"""The heal pacer (background/healpace.py) of the port against
minio_tpu's: each case of tests/test_healpace.py runs on both packages
(config from the environment, the kill switch, the token pool, the
deadline grant, the background-class latency filter, the p99 window,
the pressure probe's two inputs, the MRF drain's stretched interval).
The metrics catalog is a list the port keeps for the metrics endpoint to
come. The port's own cases: an object heal takes its pace slot before
the object's write lock; the drive wrapper (storage/diskcheck.py
MetricsDisk) feeds the pacer's window; ErrDiskFaulty sits between
ErrDiskNotFound and ErrDiskOpTimeout in both packages.
"""

import io
import threading
import time

import pytest

from minio_tpu.background import heal as jax_heal
from minio_tpu.background import healpace as jax_healpace
from minio_tpu.observability import ioflow as jax_ioflow
from minio_tpu.pipeline import admission as jax_admission
from minio_tpu.storage import diskcheck as jax_diskcheck
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu.utils import errors as jax_errors
from minio_tpu_torch.background import heal, healpace
from minio_tpu_torch.object.pools import ErasureServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.observability import ioflow
from minio_tpu_torch.pipeline import admission
from minio_tpu_torch.storage import diskcheck
from minio_tpu_torch.storage.local import LocalStorage
from minio_tpu_torch.utils import errors

PACKAGES = {"port": (healpace, ioflow, heal),
            "jax": (jax_healpace, jax_ioflow, jax_heal)}
# Each package's admission, drive wrapper, drive and error classes.
SIDES = {"port": (admission, diskcheck, lambda root: LocalStorage(
             root, endpoint="d0", device="cpu"), errors),
         "jax": (jax_admission, jax_diskcheck,
                 lambda root: JaxLocalStorage(root, endpoint="d0"),
                 jax_errors)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """(healpace, ioflow, heal) of one package, with no process pacer
    installed before or after."""
    hp, io_mod, heal_mod = PACKAGES[request.param]
    hp.reset()
    yield hp, io_mod, heal_mod
    hp.reset()


def test_config_defaults_and_env_overrides(pkg, monkeypatch):
    hp = pkg[0]
    cfg = hp.PaceConfig.from_env()
    assert cfg.enabled and cfg.tokens == 2 and cfg.queue_high == 2
    assert cfg.disk_p99_ms == 75.0 and cfg.max_wait_s == 2.0
    monkeypatch.setenv("MTPU_HEAL_PACE_TOKENS", "5")
    monkeypatch.setenv("MTPU_HEAL_PACE_QUEUE_HIGH", "7")
    monkeypatch.setenv("MTPU_HEAL_PACE_DISK_P99_MS", "150")
    monkeypatch.setenv("MTPU_HEAL_PACE_MAX_WAIT_MS", "500")
    cfg = hp.PaceConfig.from_env()
    assert (cfg.tokens, cfg.queue_high, cfg.disk_p99_ms, cfg.max_wait_s) \
        == (5, 7, 150.0, 0.5)
    monkeypatch.setenv("MTPU_HEAL_PACE_TOKENS", "0")
    monkeypatch.setenv("MTPU_HEAL_PACE_QUEUE_HIGH", "0")
    monkeypatch.setenv("MTPU_HEAL_PACE_MAX_WAIT_MS", "lots")
    cfg = hp.PaceConfig.from_env()
    assert cfg.tokens == 1 and cfg.queue_high == 1 and cfg.max_wait_s == 2.0


def test_env_kill_switch_makes_every_surface_inert(pkg, monkeypatch):
    hp = pkg[0]
    monkeypatch.setenv("MTPU_HEAL_PACE", "off")
    p = hp.reconfigure()
    assert not p.cfg.enabled
    with p.heal_slot():
        with p.heal_slot():
            pass
    assert p.snapshot()["grants_total"] == 0
    assert not p.pressured()
    hp.note_disk_op(5.0)
    assert p.snapshot()["disk_p99_ms"] == 0.0


def test_token_pool_caps_concurrent_heals(pkg):
    hp = pkg[0]
    p = hp.HealPacer(hp.PaceConfig(enabled=True, tokens=2, max_wait_s=10.0),
                     pressure_probe=lambda: False)
    peak = [0]
    mu = threading.Lock()

    def heal_one():
        with p.heal_slot():
            with mu:
                peak[0] = max(peak[0], p.snapshot()["inflight"])
            time.sleep(0.03)

    threads = [threading.Thread(target=heal_one) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert not any(t.is_alive() for t in threads)
    assert peak[0] <= 2
    assert p.snapshot()["grants_total"] == 8
    assert p.snapshot()["inflight"] == 0


def test_permanent_pressure_never_deadlocks_the_drain(pkg):
    hp = pkg[0]
    p = hp.HealPacer(
        hp.PaceConfig(enabled=True, tokens=1, max_wait_s=0.1, yield_s=0.01),
        pressure_probe=lambda: True)
    t0 = time.monotonic()
    for _ in range(20):
        with p.heal_slot():
            pass
    elapsed = time.monotonic() - t0
    snap = p.snapshot()
    assert snap["grants_total"] == 20
    assert snap["deadline_grants_total"] == 20
    assert snap["yields_total"] > 0
    assert elapsed < 20 * 0.1 * 3, f"drain took {elapsed:.1f}s"


def test_clean_path_grants_without_yielding(pkg):
    hp = pkg[0]
    p = hp.HealPacer(hp.PaceConfig(enabled=True, tokens=2, max_wait_s=2.0),
                     pressure_probe=lambda: False)
    with p.heal_slot():
        pass
    snap = p.snapshot()
    assert (snap["grants_total"], snap["deadline_grants_total"],
            snap["yields_total"]) == (1, 0, 0)


def test_probe_exception_does_not_leak_or_wedge(pkg):
    hp = pkg[0]

    def probe():
        raise RuntimeError("probe blew up")

    p = hp.HealPacer(hp.PaceConfig(enabled=True, tokens=1, max_wait_s=0.2),
                     pressure_probe=probe)
    with pytest.raises(RuntimeError):
        with p.heal_slot():
            pass
    assert p.snapshot()["inflight"] == 0


def test_p99_needs_min_samples_then_tracks_tail(pkg):
    hp = pkg[0]
    p = hp.HealPacer(hp.PaceConfig(enabled=True), pressure_probe=lambda: False)
    for _ in range(10):
        p.note_foreground_disk(0.001)
    assert p.disk_p99_s() == 0.0
    for _ in range(90):
        p.note_foreground_disk(0.001)
    p.note_foreground_disk(0.9)
    assert p.disk_p99_s() >= 0.001
    for _ in range(50):
        p.note_foreground_disk(0.9)
    assert p.disk_p99_s() == pytest.approx(0.9)


def test_default_pressure_trips_on_p99(pkg):
    """The p99 input alone: the governors idle, the foreground disk p99
    over its threshold trips the probe."""
    hp = pkg[0]
    p = hp.HealPacer(hp.PaceConfig(enabled=True, disk_p99_ms=50.0))
    assert not p.pressured()
    for _ in range(40):
        p.note_foreground_disk(0.2)
    assert p.pressured()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_default_pressure_trips_on_queue_depth_and_p99(side):
    """The probe's two inputs: the backlog of both admission governors
    against queue_high (one waiter on each makes 2), then the foreground
    disk p99 against its threshold (49 ms is under 50, 50 trips it)."""
    hp = PACKAGES[side][0]
    adm = SIDES[side][0]
    p = hp.HealPacer(hp.PaceConfig(enabled=True, queue_high=2,
                                   disk_p99_ms=50.0))
    try:
        assert not p.pressured()
        cfg = adm.AdmissionConfig(slots=1, per_client_cap=1, max_queue=4,
                                  deadline_s=5.0)
        governors = [adm.reconfigure(cfg), adm.reconfigure_read(cfg)]
        waiters = []
        for g in governors:
            g.acquire("occupant")
            t = threading.Thread(target=lambda g=g: (g.acquire("w"),
                                                     g.release("w")))
            t.start()
            waiters.append(t)
            deadline = time.monotonic() + 2
            while g.backlog() < 1:
                assert time.monotonic() < deadline
                time.sleep(0.002)
            assert p.pressured() == (g is governors[1])  # 1, then 2
        for g in governors:
            g.release("occupant")
        for t in waiters:
            t.join(5)
        assert not any(t.is_alive() for t in waiters)
        assert not p.pressured()
        for _ in range(40):
            p.note_foreground_disk(0.049)
        assert not p.pressured()
        for _ in range(40):
            p.note_foreground_disk(0.05)
        assert p.pressured()
    finally:
        adm.reconfigure()
        adm.reconfigure_read()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_metrics_disk_feeds_note_disk_op(side, tmp_path):
    """Every timed op of the drive wrapper lands in the pacer's window
    under a foreground tag, none under a background one; an op abandoned
    at its deadline lands as the whole deadline."""
    hp, io_mod, _ = PACKAGES[side]
    _, dc, local, _ = SIDES[side]
    hp.reset()
    p = hp.reconfigure(hp.PaceConfig(enabled=True))
    try:
        raw = local(str(tmp_path / side))
        raw.make_vol("v")
        w = dc.MetricsDisk(raw, None, health=dc.DiskHealth(
            "d0", config=dc.RobustConfig(op_deadline_s=0.2)))
        with io_mod.tag("heal"):
            for _ in range(25):
                w.stat_vol("v")
        assert p.disk_p99_s() == 0.0 and len(p._lat) == 0
        with io_mod.tag("get"):
            for _ in range(25):
                w.stat_vol("v")
        assert len(p._lat) == 25 and 0.0 < p.disk_p99_s() < 0.2
        hung = threading.Event()
        raw.stat_vol = lambda v: hung.wait(2)  # one op hangs
        w2 = dc.MetricsDisk(raw, None, health=dc.DiskHealth(
            "d0", config=dc.RobustConfig(op_deadline_s=0.2)))
        with io_mod.tag("get"):
            with pytest.raises(Exception) as ei:
                w2.stat_vol("v")
        hung.set()
        assert type(ei.value).__name__ == "ErrDiskOpTimeout"
        assert max(p._lat) == 0.2
    finally:
        hp.reset()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_disk_faulty_sits_between_not_found_and_timeout(side):
    """ErrDiskFaulty is an ErrDiskNotFound, and ErrDiskOpTimeout an
    ErrDiskFaulty, in both packages: every `except ErrDiskNotFound` and
    quorum reduction treats a latched or timed-out drive as offline."""
    e = SIDES[side][3]
    assert [c.__name__ for c in e.ErrDiskOpTimeout.__mro__[:5]] == [
        "ErrDiskOpTimeout", "ErrDiskFaulty", "ErrDiskNotFound",
        "StorageError", "Exception"]
    assert isinstance(e.ErrDiskFaulty("x"), e.ErrDiskNotFound)
    assert issubclass(e.ErrDiskFaulty, e.OBJECT_OP_IGNORED_ERRS)
    n, err = e.reduce_errs([e.ErrDiskFaulty("a"), e.ErrDiskOpTimeout("b"),
                            None], e.OBJECT_OP_IGNORED_ERRS)
    assert (n, err) == (1, None)


def test_note_disk_op_filters_background_ops(pkg):
    hp, io_mod, _ = pkg
    p = hp.reconfigure(hp.PaceConfig(enabled=True))
    with io_mod.tag("heal"):
        for _ in range(40):
            hp.note_disk_op(0.5)
    assert p.disk_p99_s() == 0.0
    with io_mod.tag("get"):
        for _ in range(40):
            hp.note_disk_op(0.5)
    assert p.disk_p99_s() == pytest.approx(0.5)


def test_installed_never_constructs_and_reset_clears(pkg):
    hp = pkg[0]
    assert hp.installed() is None
    hp.note_disk_op(0.1)
    assert hp.installed() is None
    p = hp.pacer()
    assert hp.installed() is p
    hp.reset()
    assert hp.installed() is None


def test_mrf_healer_stretches_interval_under_pressure(pkg):
    hp, _, heal_mod = pkg
    assert heal_mod.MRFHealer._pace_delay(0.5) == 0.5
    hp.reconfigure(hp.PaceConfig(enabled=True))
    hp.installed()._probe = lambda: True
    assert 0.5 < heal_mod.MRFHealer._pace_delay(0.5) <= 2.5
    assert heal_mod.MRFHealer._pace_delay(5.0) == 7.0
    hp.installed()._probe = lambda: False
    assert heal_mod.MRFHealer._pace_delay(0.5) == 0.5
    hp.reconfigure(hp.PaceConfig(enabled=False))
    hp.installed()._probe = lambda: True
    assert heal_mod.MRFHealer._pace_delay(0.5) == 0.5


def test_descriptors_and_snapshot_mirror_minio_tpu():
    """minio_tpu's metrics collector publishes the pacer's snapshot under
    HEALPACE_DESCRIPTORS; the port keeps the same catalog and snapshot
    for its metrics endpoint to come."""
    assert healpace.HEALPACE_DESCRIPTORS == jax_healpace.HEALPACE_DESCRIPTORS
    snaps = []
    for hp in (healpace, jax_healpace):
        p = hp.HealPacer(hp.PaceConfig(enabled=True, tokens=3),
                         pressure_probe=lambda: False)
        with p.heal_slot():
            inner = p.snapshot()
        snap = p.snapshot()
        snap["throttle_seconds_total"] = 0.0
        snaps.append((inner["inflight"], snap))
    assert snaps[0] == snaps[1]
    assert snaps[0][0] == 1 and snaps[0][1]["grants_total"] == 1


def test_heal_takes_its_slot_before_the_write_lock(tmp_path):
    """A heal yielding to foreground pressure holds no object lock: while
    it yields, a foreground writer takes the object's write lock at once;
    the heal then runs to its end."""
    disks = [LocalStorage(str(tmp_path / f"d{i}"), endpoint=f"d{i}",
                          device="cpu") for i in range(4)]
    sets = ErasureSets(disks, 4, device="cpu")
    sets.init_format()
    ol = ErasureServerPools([sets], device="cpu")
    ol.make_bucket("b")
    ol.put_object("b", "o", io.BytesIO(b"x" * 700), 700)
    pressure = threading.Event()
    pressure.set()
    p = healpace.reconfigure(healpace.PaceConfig(
        enabled=True, max_wait_s=30.0, yield_s=0.01))
    p._probe = pressure.is_set
    es = sets.sets[0]
    result = {}
    t = threading.Thread(target=lambda: result.update(
        es.heal_object("b", "o")))
    try:
        t.start()
        deadline = time.monotonic() + 10
        while p.snapshot()["yields_total"] == 0:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        t0 = time.monotonic()
        with es._locked("b", "o", writer=True):
            took = time.monotonic() - t0
            assert p.snapshot()["inflight"] == 0  # yielding, no token
        assert took < 1.0
    finally:
        pressure.clear()
        t.join(30)
        healpace.reset()
    assert not t.is_alive()
    assert result == {"healed": [], "dangling": False}
    assert p.snapshot()["grants_total"] == 1

"""The heal pacer (background/healpace.py) of the port against
minio_tpu's: each case of tests/test_healpace.py runs on both packages
(config from the environment, the kill switch, the token pool, the
deadline grant, the background-class latency filter, the p99 window,
the MRF drain's stretched interval). Two cases differ and say why: the
port's pressure probe has the foreground disk p99 alone (minio_tpu's
admission governors are not ported), and its metrics catalog is a list
the port keeps for the metrics endpoint to come. One case is the port's
own: an object heal takes its pace slot before the object's write lock.
"""

import io
import threading
import time

import pytest

from minio_tpu.background import heal as jax_heal
from minio_tpu.background import healpace as jax_healpace
from minio_tpu.observability import ioflow as jax_ioflow
from minio_tpu_torch.background import heal, healpace
from minio_tpu_torch.object.pools import ErasureServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.observability import ioflow
from minio_tpu_torch.storage.local import LocalStorage

PACKAGES = {"port": (healpace, ioflow, heal),
            "jax": (jax_healpace, jax_ioflow, jax_heal)}


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
    assert cfg.enabled and cfg.tokens == 2
    assert cfg.disk_p99_ms == 75.0 and cfg.max_wait_s == 2.0
    monkeypatch.setenv("MTPU_HEAL_PACE_TOKENS", "5")
    monkeypatch.setenv("MTPU_HEAL_PACE_DISK_P99_MS", "150")
    monkeypatch.setenv("MTPU_HEAL_PACE_MAX_WAIT_MS", "500")
    cfg = hp.PaceConfig.from_env()
    assert (cfg.tokens, cfg.disk_p99_ms, cfg.max_wait_s) == (5, 150.0, 0.5)
    monkeypatch.setenv("MTPU_HEAL_PACE_TOKENS", "0")
    monkeypatch.setenv("MTPU_HEAL_PACE_MAX_WAIT_MS", "lots")
    cfg = hp.PaceConfig.from_env()
    assert cfg.tokens == 1 and cfg.max_wait_s == 2.0


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
    """The p99 half of minio_tpu's test_default_pressure_trips_on_queue_
    depth_and_p99. Its queue-depth half needs the admission governors,
    which the port has not (test_default_pressure_has_no_admission_
    input)."""
    hp = pkg[0]
    p = hp.HealPacer(hp.PaceConfig(enabled=True, disk_p99_ms=50.0))
    assert not p.pressured()
    for _ in range(40):
        p.note_foreground_disk(0.2)
    assert p.pressured()


def test_default_pressure_has_no_admission_input(monkeypatch):
    """The port's probe reads the foreground disk p99 alone, and trips at
    its threshold: the admission backlog term waits for
    pipeline/admission.py (ROADMAP Queue 1 item 8)."""
    p = healpace.HealPacer(healpace.PaceConfig(enabled=True,
                                               disk_p99_ms=50.0))
    assert not p.pressured()
    for _ in range(40):
        p.note_foreground_disk(0.049)
    assert not p.pressured()
    p.note_foreground_disk(0.05)
    for _ in range(40):
        p.note_foreground_disk(0.05)
    assert p.pressured()


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

"""The drive health wrapper (storage/diskcheck.py: MetricsDisk, DiskHealth,
RobustConfig, configure_robustness) of the port against minio_tpu's.

Each case runs one script on both packages and compares what they do:
the registry counts, the exceptions by class name, the health states.
The cases of tests/test_diskcheck.py that need no storage-REST remote
come first; then the deadlines: an op past its deadline, three in a row
latching the breaker and the fail-fast after it, the probe letting the
drive back in, the in-flight budget, the post-hoc breaker of a one-core
host, and a 4+2 set whose wrapped drive hangs through a PUT, a degraded
GET and a heal, whose drive files must equal minio_tpu's. A hung drive
is `entry.StallingDrive`: its ops wait until released and then fail, so
a stalled op has no late side effect. Deadlines are a fraction of a
second; every stall is lifted in a `finally`.
"""

import io
import random
import threading
import time
import types
import uuid

import numpy as np
import pytest

from minio_tpu.object import erasure_objects as jax_eo
from minio_tpu.object.erasure_objects import ErasureObjects as JaxObjects
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.object.types import ObjectOptions as JaxObjectOptions
from minio_tpu.storage import diskcheck as jax_dc
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu.utils import errors as jax_errors
from minio_tpu.utils import parse_duration_s as jax_parse_duration_s
from minio_tpu_torch.entry import StallingDrive
from minio_tpu_torch.object import erasure_objects
from minio_tpu_torch.object.erasure_objects import ErasureObjects
from minio_tpu_torch.object.metadata import hash_order
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.object.types import ObjectOptions
from minio_tpu_torch.storage import diskcheck
from minio_tpu_torch.storage.local import LocalStorage
from minio_tpu_torch.utils import errors, fanout, parse_duration_s

PORT, JAX = "port", "jax"
BUCKET = "b"
SMALL_BLOCK = 12 * 4096
MOD_TIME = 1_700_000_000_123_456_789

PKG = {
    PORT: types.SimpleNamespace(
        dc=diskcheck, errors=errors, eo=erasure_objects,
        local=lambda root, ep: LocalStorage(root, endpoint=ep,
                                            device="cpu"),
        objects=lambda disks, parity: ErasureObjects(disks, parity,
                                                     device="cpu"),
        sets=lambda disks, n, parity: ErasureSets(
            disks, n, default_parity=parity, device="cpu"),
        opts=ObjectOptions, parse=parse_duration_s),
    JAX: types.SimpleNamespace(
        dc=jax_dc, errors=jax_errors, eo=jax_eo,
        local=lambda root, ep: JaxLocalStorage(root, endpoint=ep),
        objects=lambda disks, parity: JaxObjects(disks, parity),
        sets=lambda disks, n, parity: JaxErasureSets(
            disks, n, default_parity=parity),
        opts=JaxObjectOptions, parse=jax_parse_duration_s),
}

# Sub-second deadlines for the cases (minio_tpu's defaults are 30 s,
# 120 s and a 5 s probe).
FAST = dict(op_deadline_s=0.2, long_op_deadline_s=0.4, breaker_threshold=3,
            probe_interval_s=0.05)


class FakeRegistry:
    """The registry surface the wrapper calls: inc and observe."""

    def __init__(self):
        self.counts: dict = {}
        self.observed: dict = {}

    def inc(self, name, n=1, **labels):
        key = (name, tuple(sorted(labels.items())))
        self.counts[key] = self.counts.get(key, 0) + n

    def observe(self, name, value, **labels):
        key = (name, tuple(sorted(labels.items())))
        self.observed[key] = self.observed.get(key, 0) + 1

    def value(self, name, **labels) -> int:
        return self.counts.get((name, tuple(sorted(labels.items()))), 0)


class SlowDrive:
    """A raw drive whose timed ops take `delay_s` longer, then run."""

    def __init__(self, disk, ops, delay_s: float):
        self._disk, self._ops, self.delay_s = disk, frozenset(ops), delay_s

    def __getattr__(self, name):
        attr = getattr(self._disk, name)
        if name not in self._ops:
            return attr

        def call(*args, **kwargs):
            time.sleep(self.delay_s)
            return attr(*args, **kwargs)

        return call


def _health(pkg: str, ep: str = "d0", **cfg):
    p = PKG[pkg]
    return p.dc.DiskHealth(ep, config=p.dc.RobustConfig(**{**FAST, **cfg}))


def _stalled(pkg: str, root, ep: str = "d0", metrics=None, **cfg):
    """(wrapped drive, its StallingDrive) of `pkg` over root/ep."""
    p = PKG[pkg]
    raw = p.local(str(root / pkg / ep), ep)
    raw.make_vol(BUCKET)
    stall = StallingDrive(raw, p.dc._TIMED_OPS, p.errors.ErrDiskNotFound)
    return p.dc.MetricsDisk(stall, metrics, health=_health(pkg, ep, **cfg)), \
        stall


def _outcome(fn) -> tuple:
    """(error class name or None, seconds) of fn()."""
    t0 = time.perf_counter()
    try:
        fn()
        err = None
    except Exception as exc:  # noqa: BLE001 - compared by class name
        err = type(exc).__name__
    return err, time.perf_counter() - t0


def _settle(w, timeout_s: float = 2.0) -> None:
    """Wait until the drive is readmitted with nothing in flight and its
    probe has ended."""
    deadline = time.monotonic() + timeout_s
    while (w.health.is_faulty() or w.health.inflight
           or w._probe_running or w._probe_attempt_live):
        assert time.monotonic() < deadline, w.health.state()
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# the cases of tests/test_diskcheck.py


def _ops_counted(pkg, root):
    p = PKG[pkg]
    m = FakeRegistry()
    w = p.dc.MetricsDisk(p.local(str(root / pkg / "d0"), "d0"), m)
    w.make_vol("v")
    w.write_all("v", "x", b"hello")
    assert w.read_all("v", "x") == b"hello"
    return m.counts, sorted(m.observed)


def test_ops_counted_and_timed(tmp_path):
    counts, observed = _ops_counted(PORT, tmp_path)
    assert (counts, observed) == _ops_counted(JAX, tmp_path)
    for op in ("make_vol", "write_all", "read_all"):
        assert counts[("disk_ops_total", (("disk", "d0"), ("op", op)))] == 1
    assert ("disk_op_seconds", (("op", "read_all"),)) in observed


def _errors_counted(pkg, root):
    p = PKG[pkg]
    m = FakeRegistry()
    w = p.dc.MetricsDisk(p.local(str(root / pkg / "d0"), "d0"), m)
    w.make_vol("v")
    err, _ = _outcome(lambda: w.read_all("v", "missing"))
    return err, m.counts


def test_errors_counted(tmp_path):
    err, counts = _errors_counted(PORT, tmp_path)
    assert (err, counts) == _errors_counted(JAX, tmp_path)
    assert err == "ErrFileNotFound"
    key = (("disk", "d0"), ("op", "read_all"))
    assert counts[("disk_op_errors_total", key)] == 1
    assert counts[("disk_ops_total", key)] == 1


@pytest.mark.parametrize("pkg", [PORT, JAX])
def test_identity_passthrough(tmp_path, pkg):
    p = PKG[pkg]
    disk = p.local(str(tmp_path / "d0"), "d0")
    w = p.dc.MetricsDisk(disk, FakeRegistry())
    assert w.endpoint() == "d0"
    assert w.is_online()  # the port's LocalStorage has no is_local
    assert w.unwrap() is disk
    assert w.health_info() is None and w.health is None
    if pkg == PORT:
        assert diskcheck.unwrap(w) is disk and diskcheck.unwrap(disk) is disk


def _disk_id_change(pkg, root):
    p = PKG[pkg]
    disk = p.local(str(root / pkg / "d0"), "d0")
    disk.make_vol(".minio.sys")
    disk.set_disk_id("original-id")
    w = p.dc.MetricsDisk(disk, FakeRegistry(),
                         expected_disk_id="original-id")
    w.make_vol("v")
    disk.set_disk_id("swapped-id")
    w._last_check = -1e9  # force the re-validation window
    first, _ = _outcome(lambda: w.write_all("v", "x", b"data"))
    latched, _ = _outcome(lambda: w.read_all("v", "x"))
    disk.set_disk_id("original-id")  # the right disk back
    w._last_check = -1e9
    back, _ = _outcome(lambda: w.write_all("v", "x", b"data"))
    return first, latched, back


def test_disk_id_change_detected(tmp_path):
    got = _disk_id_change(PORT, tmp_path)
    assert got == _disk_id_change(JAX, tmp_path)
    assert got == ("ErrDiskNotFound", "ErrDiskNotFound", None)


def _erasure_set(pkg, root, monkeypatch):
    p = PKG[pkg]
    monkeypatch.setattr(p.eo, "BLOCK_SIZE_V2", SMALL_BLOCK)
    m = FakeRegistry()
    disks = [p.dc.MetricsDisk(p.local(str(root / pkg / f"d{i}"), f"d{i}"),
                              m) for i in range(4)]
    es = p.objects(disks, 2)
    es.make_bucket("b")
    payload = b"payload" * 1000
    es.put_object("b", "k", io.BytesIO(payload), len(payload))
    sink = io.BytesIO()
    es.get_object("b", "k", sink)
    return sink.getvalue() == payload, m.value(
        "disk_ops_total", op="write_metadata", disk="d0")


def test_metrics_disk_in_erasure_set(tmp_path, monkeypatch):
    """A set over wrapped drives works end to end: the wrapper is
    transparent to the object layer (a 7 KB object inlines: its commit is
    one write_metadata a drive)."""
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    got = _erasure_set(PORT, tmp_path, monkeypatch)
    assert got == _erasure_set(JAX, tmp_path, monkeypatch)
    assert got[0] and got[1] >= 1


# ---------------------------------------------------------------------------
# deadlines, the breaker and the probe


def _timeout(pkg, root):
    p = PKG[pkg]
    m = FakeRegistry()
    w, stall = _stalled(pkg, root, metrics=m)
    stall.hold()
    try:
        err, took = _outcome(lambda: w.stat_vol(BUCKET))
        long_err, long_took = _outcome(
            lambda: w.read_file_stream(BUCKET, "x", 0, 1))
    finally:
        stall.release()
    _settle(w)
    classes = p.errors.ErrDiskOpTimeout.__mro__
    return (err, long_err, [c.__name__ for c in classes[:4]],
            w.health.state(), m.counts), (took, long_took)


def test_op_past_its_deadline_raises_timeout(tmp_path):
    """A hung op costs its caller the deadline (the long one for a stream
    open) and raises ErrDiskOpTimeout, an ErrDiskFaulty and an
    ErrDiskNotFound, so quorum reductions read it as an offline drive."""
    got, (took, long_took) = _timeout(PORT, tmp_path)
    want, _ = _timeout(JAX, tmp_path)
    assert got == want
    assert got[0] == got[1] == "ErrDiskOpTimeout"
    assert got[2] == ["ErrDiskOpTimeout", "ErrDiskFaulty", "ErrDiskNotFound",
                      "StorageError"]
    assert got[3]["timeouts"] == 2 and got[3]["state"] == "ok"
    assert 0.2 <= took < 0.35 and 0.4 <= long_took < 0.55


def _latch(pkg, root):
    m = FakeRegistry()
    w, stall = _stalled(pkg, root, metrics=m)
    states, outcomes = [], []
    stall.hold()
    try:
        for _ in range(3):
            outcomes.append(_outcome(lambda: w.stat_vol(BUCKET)))
            states.append(w.health.state())
        fast = _outcome(lambda: w.stat_vol(BUCKET))
        states.append(w.health.state())
    finally:
        stall.release()
    _settle(w)
    return ([e for e, _ in outcomes], fast[0], states, m.counts), fast[1]


def test_three_timeouts_latch_then_fail_fast(tmp_path):
    got, fast_s = _latch(PORT, tmp_path)
    assert got == _latch(JAX, tmp_path)[0]
    errs, fast_err, states, counts = got
    assert errs == ["ErrDiskOpTimeout"] * 3 and fast_err == "ErrDiskFaulty"
    assert [s["state"] for s in states] == ["ok", "ok", "faulty", "faulty"]
    assert states[-1]["timeouts"] == 3 and states[-1]["latched"] == 1
    assert fast_s < 0.05
    assert counts[("disk_faulty_total", (("disk", "d0"),))] == 1


def _probe(pkg, root):
    m = FakeRegistry()
    w, stall = _stalled(pkg, root, metrics=m)
    stall.hold()
    try:
        for _ in range(3):
            _outcome(lambda: w.stat_vol(BUCKET))
        # Several probe rounds against the hung drive: the one attempt
        # thread is reused, never stacked.
        time.sleep(0.3)
        attempts = sum(t.name == "mtpu-dh-probe-try"
                       for t in threading.enumerate())
        still = w.health.state()["state"]
    finally:
        stall.release()
    _settle(w)
    after, _ = _outcome(lambda: w.stat_vol(BUCKET))
    return still, attempts <= 2, w.health.state(), after, m.value(
        "disk_readmit_total", disk="d0")


def test_probe_lets_the_drive_back_in(tmp_path):
    got = _probe(PORT, tmp_path)
    assert got == _probe(JAX, tmp_path)
    still, bounded, state, after, readmits = got
    assert still == "faulty" and bounded
    assert state["state"] == "ok" and state["readmitted"] == 1
    assert after is None and readmits == 1


def _budget(pkg, root):
    m = FakeRegistry()
    w, stall = _stalled(pkg, root, metrics=m, max_inflight=2,
                        breaker_threshold=100)
    stall.hold()
    threads = [threading.Thread(target=_outcome,
                                args=(lambda: w.stat_vol(BUCKET),))
               for _ in range(2)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 2
        while w.health.inflight < 2:
            assert time.monotonic() < deadline
            time.sleep(0.002)
        # Both callers leave at their deadline; their ops keep the tokens.
        for t in threads:
            t.join(2)
        assert not any(t.is_alive() for t in threads)
        rejected, took = _outcome(lambda: w.stat_vol(BUCKET))
    finally:
        stall.release()
    _settle(w)
    state = w.health.state()
    return (rejected, state["rejected"], state["timeouts"],
            m.value("disk_inflight_rejected_total", op="stat_vol",
                    disk="d0")), took


def test_inflight_budget_rejects(tmp_path):
    """Two ops stuck on a drive with a budget of two: the third waits one
    deadline for a token, then fails with ErrDiskFaulty, counted apart
    from the timeouts."""
    got, took = _budget(PORT, tmp_path)
    assert got == _budget(JAX, tmp_path)[0]
    assert got == ("ErrDiskFaulty", 1, 2, 1)
    assert 0.2 <= took < 0.35


def _posthoc(pkg, root, monkeypatch):
    p = PKG[pkg]
    if pkg == PORT:
        monkeypatch.setattr(fanout, "SINGLE_CORE", True)
    else:
        monkeypatch.setattr(jax_dc, "_SINGLE_CORE", True)
    raw = p.local(str(root / pkg / "d0"), "d0")
    raw.make_vol(BUCKET)
    slow = SlowDrive(raw, p.dc._TIMED_OPS, 0.22)
    m = FakeRegistry()
    w = p.dc.MetricsDisk(slow, m, health=_health(pkg))
    outcomes = [_outcome(lambda: w.stat_vol(BUCKET))[0] for _ in range(3)]
    latched = w.health.state()
    fast, fast_s = _outcome(lambda: w.stat_vol(BUCKET))
    slow.delay_s = 0.0  # the drive answers again: the probe readmits
    _settle(w)
    return (outcomes, latched, fast, w.health.state(), m.counts,
            threading.current_thread().name), fast_s


def test_posthoc_breaker_on_one_core(tmp_path, monkeypatch):
    """On one core an op runs on the caller's thread (no pool hop): a
    call that returns past its deadline succeeds, yet feeds the breaker,
    so after three the drive fails fast until the probe readmits it."""
    got, fast_s = _posthoc(PORT, tmp_path, monkeypatch)
    assert got == _posthoc(JAX, tmp_path, monkeypatch)[0]
    outcomes, latched, fast, state, counts, _ = got
    assert outcomes == [None] * 3
    assert latched["state"] == "faulty" and latched["timeouts"] == 3
    assert fast == "ErrDiskFaulty" and fast_s < 0.05
    assert state["state"] == "ok" and state["readmitted"] == 1
    assert counts[("disk_op_timeouts_total",
                   (("disk", "d0"), ("op", "stat_vol")))] == 3


def _fast_failure(pkg, root):
    w, stall = _stalled(pkg, root)
    stall.hold()
    try:
        for _ in range(2):
            _outcome(lambda: w.stat_vol(BUCKET))
    finally:
        stall.release()
    _settle(w)
    missing, _ = _outcome(lambda: w.read_all(BUCKET, "absent"))
    stall.hold()
    try:
        for _ in range(2):
            _outcome(lambda: w.stat_vol(BUCKET))
        state = w.health.state()
    finally:
        stall.release()
    _settle(w)
    return missing, state


def test_fast_failure_resets_the_streak(tmp_path):
    """A fast failure proves the drive responsive: two timeouts, a
    missing file, two more timeouts do not latch."""
    got = _fast_failure(PORT, tmp_path)
    assert got == _fast_failure(JAX, tmp_path)
    assert got[0] == "ErrFileNotFound"
    assert got[1]["state"] == "ok" and got[1]["timeouts"] == 4
    assert got[1]["consecutiveTimeouts"] == 2


def test_configure_robustness_and_durations():
    """The `drive` knobs parse alike (Go durations, junk to defaults) and
    land on the live ROBUST."""
    kvs = {"enable": "off", "op_deadline": "250ms", "long_op_deadline": "2m",
           "hedge_delay": "junk", "straggler_grace": "3",
           "probe_interval": "1h", "breaker_threshold": "0",
           "max_inflight": "many"}
    got = {}
    for pkg in (PORT, JAX):
        dc = PKG[pkg].dc
        with dc.robust_overrides():
            old = vars(dc.ROBUST).copy()
            try:
                got[pkg] = vars(dc.configure_robustness(kvs)).copy()
            finally:
                vars(dc.ROBUST).update(old)
    assert got[PORT] == got[JAX]
    assert got[PORT] == {
        "enabled": False, "op_deadline_s": 0.25, "long_op_deadline_s": 120.0,
        "hedge_delay_s": 0.15, "straggler_grace_s": 3.0,
        "breaker_threshold": 1, "probe_interval_s": 3600.0,
        "max_inflight": 16}
    for text in ("10s", "100ms", "1m", "1h", "2.5", "", "x", " 7S "):
        assert parse_duration_s(text, default=-1.0) == \
            jax_parse_duration_s(text, default=-1.0)
    assert diskcheck.RobustConfig() == diskcheck.RobustConfig(
        **vars(jax_dc.RobustConfig()))


def test_disabled_health_skips_the_deadline(tmp_path):
    """With the `drive` subsystem off the wrapper calls straight through:
    no pool, no deadline, no breaker."""
    got = {}
    for pkg in (PORT, JAX):
        p = PKG[pkg]
        raw = p.local(str(tmp_path / pkg / "d0"), "d0")
        raw.make_vol(BUCKET)
        w = p.dc.MetricsDisk(SlowDrive(raw, p.dc._TIMED_OPS, 0.25), None,
                             health=_health(pkg, enabled=False))
        got[pkg] = (_outcome(lambda: w.stat_vol(BUCKET))[0],
                    w.health.state(), w._deadline_pool is None)
    assert got[PORT] == got[JAX] == (None, got[PORT][1], True)
    assert got[PORT][1]["timeouts"] == 0


# ---------------------------------------------------------------------------
# a 4+2 set with a hung drive, against minio_tpu's


def _seed_uuids(mp, seed: int) -> None:
    rng = random.Random(seed)
    mp.setattr(uuid, "uuid4",
               lambda: uuid.UUID(int=rng.getrandbits(128), version=4))


def _tree(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _hung_set(pkg, root, stalled: int, payload: bytes):
    """PUT, degraded GET and heal on a 4+2 set over wrapped drives whose
    drive `stalled` hangs until the heal."""
    p = PKG[pkg]
    out: dict = {}
    with pytest.MonkeyPatch.context() as mp, \
            p.dc.robust_overrides(**FAST, hedge_delay_s=0.05,
                                  straggler_grace_s=0.2):
        _seed_uuids(mp, 7)
        mp.setattr(p.eo, "BLOCK_SIZE_V2", SMALL_BLOCK)
        stall = None
        disks = []
        for i in range(6):
            raw = p.local(str(root / f"d{i}"), f"d{i}")
            if i == stalled:
                raw = stall = StallingDrive(raw, p.dc._TIMED_OPS,
                                            p.errors.ErrDiskNotFound)
            disks.append(p.dc.MetricsDisk(raw, None,
                                          health=p.dc.DiskHealth(f"d{i}")))
        sets = p.sets(disks, 6, 2)
        sets.init_format()
        sets.make_bucket(BUCKET)
        w = disks[stalled]
        stall.hold()
        try:
            sets.put_object(BUCKET, "obj", io.BytesIO(payload), len(payload),
                            p.opts(mod_time_ns=MOD_TIME))
            sink = io.BytesIO()
            sets.get_object(BUCKET, "obj", sink)
            out["get_exact"] = sink.getvalue() == payload
            out["timeouts"] = w.health.timeouts_total
            sets.get_object_info(BUCKET, "obj")
            out["latched"] = w.health.is_faulty()
            timeouts = w.health.timeouts_total
            sink = io.BytesIO()
            sets.get_object(BUCKET, "obj", sink)
            out["latched_get_exact"] = sink.getvalue() == payload
            out["latched_get_paid_deadline"] = \
                w.health.timeouts_total != timeouts
        finally:
            stall.release()
        _settle(w)
        state = w.health.state()
        out["latches"] = (state["latched"], state["readmitted"])
        out["heal"] = sets.heal_object(BUCKET, "obj")
        sink = io.BytesIO()
        sets.get_object(BUCKET, "obj", sink)
        out["get_after_heal"] = sink.getvalue() == payload
    return out


def test_hung_drive_put_get_heal_matches_minio_tpu(tmp_path, monkeypatch):
    """One drive of a 4+2 set hangs through a PUT (write quorum on five)
    and degraded GETs before and after the breaker latches (that drive
    holds a data shard); once it answers again and the probe has let it
    back in, the heal rebuilds it: every drive file equals minio_tpu's
    under the same stall."""
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "4096")
    dist = hash_order(f"{BUCKET}/obj", 6)
    stalled = next(i for i in range(6) if dist[i] - 1 < 4)
    payload = np.random.default_rng(3).bytes(2 * SMALL_BLOCK + 777)
    got = _hung_set(PORT, tmp_path / PORT, stalled, payload)
    assert got == _hung_set(JAX, tmp_path / JAX, stalled, payload)
    # The PUT pays the part's create deadline (the drive has no writer,
    # so no commit op), the GET its metadata read's, and one more
    # metadata read the third, which latches the breaker.
    assert got["timeouts"] == 2 and got["latched"]
    assert got["get_exact"] and got["latched_get_exact"]
    assert not got["latched_get_paid_deadline"]
    assert got["latches"] == (1, 1) and got["heal"]["healed"]
    assert got["get_after_heal"]
    port_files, jax_files = _tree(tmp_path / PORT), _tree(tmp_path / JAX)
    assert port_files == jax_files
    assert any(k.startswith(f"d{stalled}/{BUCKET}/obj/") and
               k.endswith("part.1") for k in port_files)

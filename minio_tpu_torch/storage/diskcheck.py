"""Per-op metrics, disk-id validation and in-band health tracking over
the drive storage, the port's copy of minio_tpu/storage/diskcheck.py
(MinIO's xlStorageDiskIDCheck wrapper, cmd/xl-storage-disk-id-check.go:
every storage call is counted and timed, the disk's identity is
re-verified so a swapped disk surfaces as ErrDiskNotFound, and a health
tracker latches a hung drive faulty instead of letting it wedge every
caller).

The wrapper is a transparent proxy: callers keep the same storage
surface. Metrics go to a registry when one is given (the Server gives
its own), under minio_tpu's names:
  disk_ops_total{op,disk}, disk_op_errors_total{op,disk},
  disk_op_seconds{op} (histogram), disk_op_timeouts_total{op,disk},
  disk_inflight_rejected_total{op,disk}, disk_faulty_total{disk},
  disk_readmit_total{disk}.

Health tracking (with a DiskHealth):
- every timed op runs under a wall-clock deadline: a hung drive costs
  the caller at most the deadline;
- a per-disk budget of in-flight ops: once `max_inflight` ops are stuck
  on one disk, further calls fail fast with ErrDiskFaulty;
- a breaker that latches the disk faulty (ErrDiskFaulty) after N timeouts
  in a row, with a background probe that lets it back in once it answers
  again.

Under a request trace every op is one `disk` span labelled
"op:endpoint", the leaf of the request's tree (which drive a fan-out
waited on). The op runs on the drive's own pool thread when guarded on
a multi-core host; that thread takes over the caller's trace and op
tag, so the bytes it moves count under the request.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from contextlib import contextmanager
from dataclasses import dataclass

from ..observability import carry as obs_carry
from ..observability import spans
from ..utils import fanout, parse_duration_s
from ..utils.errors import ErrDiskFaulty, ErrDiskNotFound, ErrDiskOpTimeout

# The ops that are counted and timed (MinIO's storageMetric constants).
_TIMED_OPS = frozenset({
    "disk_info", "make_vol", "make_vol_bulk", "list_vols", "stat_vol",
    "delete_vol", "list_dir", "walk_dir", "delete_version",
    "delete_versions", "write_metadata", "update_metadata", "read_version",
    "rename_data", "list_versions", "read_file", "append_file",
    "create_file", "read_file_stream", "create_file_writer", "rename_file",
    "check_parts", "check_file", "delete", "verify_file", "stat_info_file",
    "write_all", "read_all",
})

# Ops with a longer deadline: walks stream a whole tree, stream opens and
# file creates may touch cold metadata.
_LONG_OPS = frozenset({
    "walk_dir", "read_file_stream", "create_file_writer", "create_file",
    "verify_file", "list_dir", "list_vols", "delete",
})

# Identity and liveness ops pass through without the disk-id gate (the
# gate itself uses them).
_PASSTHROUGH = frozenset({
    "is_online", "is_local", "hostname", "endpoint", "get_disk_id",
    "set_disk_id", "close",
})

_ID_CHECK_INTERVAL_S = 5.0


def _pace_note(elapsed_s: float) -> None:
    """Feed a timed disk-op latency to the heal pacer's foreground
    pressure window; the pacer drops background op classes."""
    from ..background import healpace

    healpace.note_disk_op(elapsed_s)


@dataclass
class RobustConfig:
    """Process-wide hung-drive tolerance knobs (minio_tpu's config
    subsystem `drive`). One mutable instance, `ROBUST`, is what both the
    storage wrapper and the erasure fan-outs read, so the deadline a PUT
    observes and the deadline one disk op gets cannot drift apart."""

    enabled: bool = True
    op_deadline_s: float = 30.0
    long_op_deadline_s: float = 120.0
    hedge_delay_s: float = 0.15
    straggler_grace_s: float = 2.0
    breaker_threshold: int = 3
    probe_interval_s: float = 5.0
    max_inflight: int = 16


ROBUST = RobustConfig()


def configure_robustness(kvs) -> RobustConfig:
    """Apply the `drive` subsystem's key-value settings (config.Config's
    resolved view: env > stored > default) onto the live ROBUST."""
    ROBUST.enabled = kvs.get("enable", "on") != "off"
    for attr, key, default in (
        ("op_deadline_s", "op_deadline", 30.0),
        ("long_op_deadline_s", "long_op_deadline", 120.0),
        ("hedge_delay_s", "hedge_delay", 0.15),
        ("straggler_grace_s", "straggler_grace", 2.0),
        ("probe_interval_s", "probe_interval", 5.0),
    ):
        setattr(ROBUST, attr,
                parse_duration_s(kvs.get(key, ""), default=default))
    try:
        ROBUST.breaker_threshold = max(1, int(kvs.get("breaker_threshold",
                                                      "3")))
    except ValueError:
        ROBUST.breaker_threshold = 3
    try:
        ROBUST.max_inflight = max(1, int(kvs.get("max_inflight", "16")))
    except ValueError:
        ROBUST.max_inflight = 16
    return ROBUST


@contextmanager
def robust_overrides(**kw):
    """Temporarily override ROBUST fields (tests, what-if runs)."""
    old = {k: getattr(ROBUST, k) for k in kw}
    for k, v in kw.items():
        setattr(ROBUST, k, v)
    try:
        yield ROBUST
    finally:
        for k, v in old.items():
            setattr(ROBUST, k, v)


class DiskHealth:
    """Per-disk health state: the in-flight token budget and the
    consecutive-timeout breaker (MinIO's diskHealthTracker). Pure state:
    the deadlines and the probe live in MetricsDisk."""

    def __init__(self, endpoint: str = "", config: RobustConfig | None = None):
        self.endpoint = endpoint
        self.cfg = config or ROBUST
        self._lock = threading.Lock()
        self._tokens_cv = threading.Condition(self._lock)
        self._inflight = 0          # guarded-by: _tokens_cv|_lock
        self._consec_timeouts = 0   # guarded-by: _lock
        self._faulty = False        # guarded-by: _lock
        # Monotonic totals for admin and tests.
        self.timeouts_total = 0
        self.latched_total = 0
        self.readmitted_total = 0
        self.rejected_total = 0
        self.last_latch_monotonic = 0.0

    # --- token budget ---

    def acquire(self, timeout_s: float = 0.0) -> bool:
        """Take one in-flight token, waiting up to timeout_s for one to
        free. Rejects (False) only when none frees for the whole window."""
        deadline = time.monotonic() + timeout_s
        with self._tokens_cv:
            while self._inflight >= self.cfg.max_inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    self.rejected_total += 1
                    return False
                self._tokens_cv.wait(left)
            self._inflight += 1
            return True

    def release(self) -> None:
        with self._tokens_cv:
            self._inflight -= 1
            self._tokens_cv.notify()

    @property
    def inflight(self) -> int:
        return self._inflight  # a racy read: gauges and caps

    # --- breaker ---

    def is_faulty(self) -> bool:
        # A racy read: a stale False does one op (its deadline still
        # bounds it), a stale True fails fast one op late.
        return self._faulty

    def record_ok(self) -> None:
        with self._lock:
            self._consec_timeouts = 0

    def record_timeout(self) -> bool:
        """Count one deadline miss; True when it latches the breaker (the
        caller starts the probe)."""
        with self._lock:
            self.timeouts_total += 1
            self._consec_timeouts += 1
            if (not self._faulty
                    and self._consec_timeouts >= self.cfg.breaker_threshold):
                self._faulty = True
                self.latched_total += 1
                self.last_latch_monotonic = time.monotonic()
                return True
            return False

    def readmit(self) -> None:
        with self._lock:
            self._faulty = False
            self._consec_timeouts = 0
            self.readmitted_total += 1

    def state(self) -> dict:
        """A racy snapshot: consistency across fields is not promised."""
        return {
            "state": "faulty" if self._faulty else "ok",
            "inflight": self._inflight,
            "timeouts": self.timeouts_total,
            "latched": self.latched_total,
            "readmitted": self.readmitted_total,
            "rejected": self.rejected_total,
            "consecutiveTimeouts": self._consec_timeouts,
        }


class MetricsDisk:
    """Transparent storage proxy adding per-op metrics, periodic disk-id
    re-validation (MinIO's checkDiskStale) and, with `health`, per-op
    deadlines and the faulty-disk breaker.

    A wrapped method is cached on first lookup, so a change to the
    wrapped drive's methods after the first op does not show through."""

    def __init__(self, disk, metrics=None, expected_disk_id: str = "",
                 health: DiskHealth | None = None):
        self._disk = disk
        self._metrics = metrics
        self._expected_id = expected_disk_id
        self._last_check = 0.0
        self._stale = False
        self._health = health
        if health is not None and not health.endpoint:
            try:
                health.endpoint = disk.endpoint()
            except Exception:  # noqa: BLE001 - cosmetic only
                pass
        self._deadline_pool: ThreadPoolExecutor | None = None  # guarded-by: _probe_lock
        self._probe_lock = threading.Lock()
        self._probe_running = False         # guarded-by: _probe_lock
        self._probe_attempt_live = False    # guarded-by: _probe_lock

    def __getattr__(self, name: str):
        attr = getattr(self._disk, name)
        if name in _PASSTHROUGH or name not in _TIMED_OPS:
            return attr
        wrapped = self._wrap(name, attr)
        self.__dict__[name] = wrapped
        return wrapped

    def health_info(self) -> dict | None:
        """The health tracker's snapshot; None without one."""
        if self._health is None:
            return None
        return self._health.state()

    @property
    def health(self) -> DiskHealth | None:
        return self._health

    def _inc(self, name: str, **labels) -> None:
        if self._metrics is not None:
            self._metrics.inc(name, **labels)

    def _observe(self, name: str, value: float, **labels) -> None:
        if self._metrics is not None:
            self._metrics.observe(name, value, **labels)

    def _wrap(self, op: str, fn):
        def call(*args, **kwargs):
            self._check_id()
            h = self._health
            guarded = h is not None and h.cfg.enabled
            if guarded and not fanout.SINGLE_CORE:
                if spans.current() is None:
                    return self._call_guarded(op, fn, args, kwargs)
                # The op's latency on the request's span timeline: the
                # leaf of the tree, naming the drive a fan-out waited on.
                t0s = time.monotonic_ns()
                try:
                    return self._call_guarded(op, fn, args, kwargs)
                finally:
                    spans.record("disk", f"{op}:{self._disk.endpoint()}",
                                 time.monotonic_ns() - t0s)
            if guarded and h.is_faulty():
                # One core skips the per-disk pool (a thread hand-off an
                # op) but keeps the breaker: a latched disk fails fast,
                # and a direct call that returns past its deadline feeds
                # the breaker afterwards.
                raise ErrDiskFaulty(
                    f"{self._disk.endpoint()}: circuit open, awaiting probe")
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            except Exception:
                if guarded:
                    # A slow failure is breaker evidence like a slow
                    # success; only a fast one proves the disk responsive.
                    self._posthoc_breaker(op, time.perf_counter() - t0)
                self._inc("disk_op_errors_total", op=op,
                          disk=self._disk.endpoint())
                raise
            finally:
                self._inc("disk_ops_total", op=op,
                          disk=self._disk.endpoint())
                self._observe("disk_op_seconds", time.perf_counter() - t0,
                              op=op)
                if spans.current() is not None:
                    spans.record("disk", f"{op}:{self._disk.endpoint()}",
                                 int((time.perf_counter() - t0) * 1e9))
                _pace_note(time.perf_counter() - t0)
            if guarded:
                self._posthoc_breaker(op, time.perf_counter() - t0)
            return out

        call.__name__ = op
        return call

    # --- deadline and breaker ---

    def _posthoc_breaker(self, op: str, elapsed: float) -> None:
        """The breaker's feed on the direct-call (one-core) path: a call
        that returned past its deadline counts as a timeout; a faster one
        resets the streak."""
        h = self._health
        if elapsed > self._deadline_for(op):
            self._inc("disk_op_timeouts_total", op=op,
                      disk=self._disk.endpoint())
            if h.record_timeout():
                self._inc("disk_faulty_total", disk=self._disk.endpoint())
                self._start_probe()
        else:
            h.record_ok()

    def _deadline_for(self, op: str) -> float:
        cfg = self._health.cfg
        return (cfg.long_op_deadline_s if op in _LONG_OPS
                else cfg.op_deadline_s)

    def start_pool(self) -> None:
        """Start the drive's pool and one worker now, where the health
        wrapper sends each op to it (guarded, on a multi-core host)."""
        h = self._health
        if h is not None and h.cfg.enabled and not fanout.SINGLE_CORE:
            fanout.prestart(self._pool(), 1)

    def _pool(self) -> ThreadPoolExecutor:
        """The disk's own executor, made on first use and sized to the
        token budget, so it never queues behind stuck ops: one hung disk
        pins at most max_inflight threads here."""
        pool = self._deadline_pool  # a stale None falls through to the lock
        if pool is None:
            with self._probe_lock:
                pool = self._deadline_pool
                if pool is None:
                    pool = ThreadPoolExecutor(
                        max_workers=self._health.cfg.max_inflight,
                        thread_name_prefix=(
                            f"mtpu-dh-{self._disk.endpoint()[:16]}"))
                    self._deadline_pool = pool
        return pool

    def _call_guarded(self, op: str, fn, args, kwargs):
        h = self._health
        ep = self._disk.endpoint()
        if h.is_faulty():
            raise ErrDiskFaulty(f"{ep}: circuit open, awaiting probe")
        deadline_s = self._deadline_for(op)
        t0 = time.perf_counter()
        if not h.acquire(timeout_s=deadline_s):
            # No token freed for a whole deadline: everything in flight
            # is stuck. Counted apart from deadline misses.
            self._inc("disk_inflight_rejected_total", op=op, disk=ep)
            raise ErrDiskFaulty(
                f"{ep}: {h.cfg.max_inflight} ops in flight for {deadline_s}s")

        def run():
            try:
                return fn(*args, **kwargs)
            finally:
                # The token comes back when the op really ends, even if
                # its caller left at the deadline.
                h.release()

        # The op gets its whole deadline from submission; the token wait
        # above is bounded apart. The pool thread carries the caller's
        # trace and op tag.
        fut = self._pool().submit(obs_carry(run))
        try:
            out = fut.result(timeout=deadline_s)
        except _FutTimeout:
            latched = h.record_timeout()
            self._inc("disk_op_timeouts_total", op=op, disk=ep)
            self._inc("disk_op_errors_total", op=op, disk=ep)
            self._inc("disk_ops_total", op=op, disk=ep)
            if latched:
                self._inc("disk_faulty_total", disk=ep)
                self._start_probe()
            # An abandoned op cost its caller the whole deadline.
            _pace_note(deadline_s)
            raise ErrDiskOpTimeout(
                f"{op} on {ep} exceeded {deadline_s}s deadline") from None
        except Exception:
            # A fast failure proves the disk responsive.
            h.record_ok()
            self._inc("disk_op_errors_total", op=op, disk=ep)
            self._inc("disk_ops_total", op=op, disk=ep)
            self._observe("disk_op_seconds", time.perf_counter() - t0, op=op)
            raise
        h.record_ok()
        self._inc("disk_ops_total", op=op, disk=ep)
        self._observe("disk_op_seconds", time.perf_counter() - t0, op=op)
        _pace_note(time.perf_counter() - t0)
        return out

    # --- the re-admission probe ---

    def _start_probe(self):
        with self._probe_lock:
            if self._probe_running:
                return
            self._probe_running = True
        threading.Thread(
            target=self._probe_loop, daemon=True,
            name=f"mtpu-dh-probe-{self._disk.endpoint()[:16]}").start()

    def _probe_loop(self):
        h = self._health
        try:
            while h.is_faulty():
                time.sleep(h.cfg.probe_interval_s)
                if self._probe_once():
                    h.readmit()
                    self._inc("disk_readmit_total",
                              disk=self._disk.endpoint())
                    return
        finally:
            with self._probe_lock:
                self._probe_running = False
            # Latched again between readmit and exit: probe again.
            if h.is_faulty():
                self._start_probe()

    def _probe_once(self) -> bool:
        """One deadline-bounded liveness attempt on the raw disk. At most
        one attempt thread is in flight: a hung attempt is not stacked
        every interval, and a later round reads its verdict."""
        with self._probe_lock:
            if self._probe_attempt_live:
                return False
            self._probe_attempt_live = True
        done = threading.Event()
        verdict = {"ok": False}

        def attempt():
            try:
                self._disk.disk_info()
                verdict["ok"] = True
            except Exception:  # noqa: BLE001 - still sick
                verdict["ok"] = False
            finally:
                with self._probe_lock:
                    self._probe_attempt_live = False
                done.set()

        threading.Thread(target=attempt, daemon=True,
                         name="mtpu-dh-probe-try").start()
        done.wait(timeout=self._health.cfg.op_deadline_s)
        return verdict["ok"]

    def _check_id(self):
        """Re-verify that the wrapped disk still carries the expected id:
        a replaced disk fails every op with ErrDiskNotFound, re-probed
        once an interval, until the right one is back."""
        if not self._expected_id:
            return
        now = time.monotonic()
        if self._stale:
            if now - self._last_check >= _ID_CHECK_INTERVAL_S:
                self._last_check = now
                if self._disk.get_disk_id() == self._expected_id:
                    self._stale = False
                    return
            raise ErrDiskNotFound(
                f"stale disk: expected id {self._expected_id}")
        if now - self._last_check < _ID_CHECK_INTERVAL_S:
            return
        self._last_check = now
        actual = self._disk.get_disk_id()
        if actual and actual != self._expected_id:
            self._stale = True
            raise ErrDiskNotFound(
                f"disk id changed: have {actual}, want {self._expected_id}")

    def unwrap(self):
        return self._disk

    def __repr__(self):  # pragma: no cover - debug aid
        return f"MetricsDisk({self._disk!r})"


def unwrap(disk):
    """The raw drive under a MetricsDisk, or `disk` itself."""
    return disk.unwrap() if isinstance(disk, MetricsDisk) else disk

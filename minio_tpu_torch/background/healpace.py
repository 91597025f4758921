"""Adaptive heal pacing, the port's copy of minio_tpu/background/
healpace.py.

A dead-drive heal storm competes with foreground traffic for the same
drives. The pacer sits at the one choke point every heal passes through
(`ErasureObjects.heal_object`) and makes heal I/O borrow capacity
instead of taking it:

- a heal takes one of a small fixed pool of tokens;
- before taking a token it yields while foreground pressure is high;
- it never waits longer than `max_wait_s`: at the deadline it is granted
  anyway (counted apart), so pressure slows the MRF drain and can never
  deadlock it.

The pacer holds no lock while a heal runs (the token is a counter, not a
mutex), so it adds no edge to the lock graph.

Pressure is (a) the backlog of either admission governor
(`pipeline/admission.py`) at or over `queue_high`, or (b) the foreground
disk p99 over a sliding window, which the drive wrapper
(`storage/diskcheck.py` `MetricsDisk`) feeds through `note_disk_op` on
every timed op.

Disarm with `MTPU_HEAL_PACE=off`: every surface becomes an inert no-op.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from dataclasses import dataclass

# Op classes that are background work themselves: their disk latencies
# must not count as foreground pressure, or the pacer would throttle
# heals in response to their own reads.
_BACKGROUND_OPS = ("heal", "scan", "replication", "untagged")

# Below this many samples the p99 is noise: report 0.0.
_MIN_P99_SAMPLES = 20


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass(frozen=True)
class PaceConfig:
    enabled: bool = True
    tokens: int = 2               # concurrent heal token pool
    queue_high: int = 2           # admission backlog that counts as pressure
    disk_p99_ms: float = 75.0     # foreground disk p99 that counts as pressure
    max_wait_s: float = 2.0       # deadline-grant bound a heal
    yield_s: float = 0.05         # sleep quantum while yielding
    window: int = 512             # foreground disk latency ring size

    @classmethod
    def from_env(cls) -> "PaceConfig":
        enabled = os.environ.get("MTPU_HEAL_PACE", "on").lower() not in (
            "0", "off", "false", "no")
        return cls(
            enabled=enabled,
            tokens=max(1, _env_int("MTPU_HEAL_PACE_TOKENS", 2)),
            queue_high=max(1, _env_int("MTPU_HEAL_PACE_QUEUE_HIGH", 2)),
            disk_p99_ms=_env_float("MTPU_HEAL_PACE_DISK_P99_MS", 75.0),
            max_wait_s=_env_float("MTPU_HEAL_PACE_MAX_WAIT_MS", 2000.0)
            / 1000.0)


class HealPacer:
    """Token pool and pressure gate for background heal I/O.
    `pressure_probe`, () -> bool, replaces the default probe (tests)."""

    def __init__(self, config: PaceConfig | None = None,
                 pressure_probe=None):
        self.cfg = config or PaceConfig.from_env()
        self._cv = threading.Condition()
        self._inflight = 0            # guarded-by: _cv
        self._grants = 0              # guarded-by: _cv
        self._deadline_grants = 0     # guarded-by: _cv
        self._yields = 0              # guarded-by: _cv
        self._throttle_s = 0.0        # guarded-by: _cv
        self._lat_mu = threading.Lock()
        self._lat = deque(maxlen=self.cfg.window)  # guarded-by: _lat_mu
        self._probe = pressure_probe or self._default_pressure

    # -- foreground latency feed --

    def note_foreground_disk(self, seconds: float) -> None:
        with self._lat_mu:
            self._lat.append(seconds)

    def disk_p99_s(self) -> float:
        with self._lat_mu:
            samples = sorted(self._lat)
        if len(samples) < _MIN_P99_SAMPLES:
            return 0.0
        idx = min(len(samples) - 1, int(0.99 * (len(samples) - 1) + 0.5))
        return samples[idx]

    # -- pressure --

    def _default_pressure(self) -> bool:
        """The queue depth of both admission governors against
        `queue_high`, then the foreground disk p99 against its
        threshold."""
        from ..pipeline import admission

        backlog = (admission.governor().backlog()
                   + admission.read_governor().backlog())
        if backlog >= self.cfg.queue_high:
            return True
        return self.disk_p99_s() * 1000.0 >= self.cfg.disk_p99_ms

    def pressured(self) -> bool:
        if not self.cfg.enabled:
            return False
        return bool(self._probe())

    # -- the slot --

    @contextlib.contextmanager
    def heal_slot(self):
        """Take a heal token, yielding to foreground pressure, but always
        granting within max_wait_s (a deadline grant)."""
        if not self.cfg.enabled:
            yield
            return
        t0 = time.monotonic()
        deadline = t0 + self.cfg.max_wait_s
        forced = False
        # Back off while the foreground is pressured, holding no lock.
        while self.pressured():
            if time.monotonic() >= deadline:
                forced = True
                break
            with self._cv:
                self._yields += 1
            time.sleep(self.cfg.yield_s)
        # Take a token within the remaining budget.
        with self._cv:
            while self._inflight >= self.cfg.tokens:
                left = deadline - time.monotonic()
                if left <= 0:
                    forced = True
                    break
                self._cv.wait(left)
            self._inflight += 1
            self._grants += 1
            if forced:
                self._deadline_grants += 1
            self._throttle_s += time.monotonic() - t0
        try:
            yield
        finally:
            with self._cv:
                self._inflight -= 1
                self._cv.notify()

    def snapshot(self) -> dict:
        with self._cv:
            return {
                "enabled": self.cfg.enabled,
                "tokens": self.cfg.tokens,
                "inflight": self._inflight,
                "grants_total": self._grants,
                "deadline_grants_total": self._deadline_grants,
                "yields_total": self._yields,
                "throttle_seconds_total": round(self._throttle_s, 6),
                "disk_p99_ms": round(self.disk_p99_s() * 1000.0, 3),
            }


# The process pacer.

_pacer: HealPacer | None = None  # guarded-by: _pacer_mu
_pacer_mu = threading.Lock()


def pacer() -> HealPacer:
    """The process pacer, built from the environment on first use."""
    global _pacer
    p = _pacer  # a stale None falls through to the locked check
    if p is None:
        with _pacer_mu:
            if _pacer is None:
                _pacer = HealPacer()
            p = _pacer
    return p


def reconfigure(config: PaceConfig | None = None) -> HealPacer:
    """Swap the process pacer. Heals in flight release their token
    against the old one."""
    global _pacer
    with _pacer_mu:
        _pacer = HealPacer(config or PaceConfig.from_env())
        return _pacer


def reset() -> None:
    """Drop the process pacer; the next pacer() rebuilds it."""
    global _pacer
    with _pacer_mu:
        _pacer = None


def installed() -> HealPacer | None:
    """The live pacer or None; never builds one."""
    return _pacer


def note_disk_op(seconds: float) -> None:
    """The foreground disk latency feed: a no-op until a pacer exists and
    is enabled, and for background op classes (heal, scan, ...)."""
    p = _pacer
    if p is None or not p.cfg.enabled:
        return
    from ..observability import ioflow

    if ioflow.current_op() in _BACKGROUND_OPS:
        return
    p.note_foreground_disk(seconds)


# The pacer's series in the metrics catalog (observability/metrics_v2.py,
# whose collector mirrors snapshot() at each scrape).
HEALPACE_DESCRIPTORS = [
    ("heal_pace_tokens", "gauge",
     "Configured background heal token pool size"),
    ("heal_pace_inflight", "gauge",
     "Heal operations currently holding a pace token"),
    ("heal_pace_disk_p99_seconds", "gauge",
     "Sliding-window foreground disk p99 seen by the heal pacer"),
    ("heal_pace_grants_total", "counter",
     "Heal pace tokens granted"),
    ("heal_pace_deadline_grants_total", "counter",
     "Heal pace tokens granted at the max-wait deadline despite "
     "pressure or token exhaustion"),
    ("heal_pace_yields_total", "counter",
     "Heal pacing yield quanta slept due to foreground pressure"),
    ("heal_pace_throttle_seconds_total", "counter",
     "Total seconds heals spent waiting for a pace token"),
]

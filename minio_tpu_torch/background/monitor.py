"""Disk liveness monitoring, the port's copy of minio_tpu/background/
monitor.py: MinIO's monitorAndConnectEndpoints (cmd/erasure-sets.go:
282-308) and its reconnect event, which drains the MRF (:88-96).

Each tick every drive of every erasure set is probed. Probes run on a
thread of their own each, so one hung drive never stalls the sweep or
the detection of others. A drive is pulled from its set (its slot
becomes None, MinIO's OfflineDisk) after `fail_threshold` consecutive
failed probes, and restored on the first good one. A write during an
outage lands in the set's MRF queue, and a reconnect drains the queue
at once, so the returned drive catches up.

The port's drives (`LocalStorage`) have no `ping`: `disk_info`, which
raises while `set_online(False)` holds or the drive's root is gone, is
the probe.
"""

from __future__ import annotations

import threading
import time

# At most one probe in flight a drive slot, so hung probes leak at most
# one thread a slot.
PROBE_TIMEOUT_S = 20.0

# A probe thread that never returns would pin its slot's pending entry
# for ever, and a recovered or replaced drive could not come back
# without a restart. Past this age the entry is evicted and probing
# resumes; the zombie's late result is discarded by its generation.
PROBE_PENDING_MAX_AGE_S = 6 * PROBE_TIMEOUT_S

# At most this many evicted probe threads still running a slot; past the
# cap eviction pauses until one returns (such a slot stays offline).
PROBE_MAX_ZOMBIES = 4


def _probe(disk) -> bool:
    try:
        ping = getattr(disk, "ping", None)
        if ping is not None:
            ping()
        else:
            disk.disk_info()
        return True
    except Exception:  # noqa: BLE001 - any failure means offline
        return False


class DiskMonitor:
    """The health-check loop over an ErasureServerPools object layer."""

    def __init__(self, object_layer, mrf_healer=None, interval_s: float = 1.0,
                 fail_threshold: int = 2):
        self.ol = object_layer
        self.mrf = mrf_healer
        self.interval_s = interval_s
        self.fail_threshold = max(1, fail_threshold)
        # (id(set), slot) -> the drive pulled from that slot.
        self._offline: dict[tuple[int, int], object] = {}
        self._fails: dict[tuple[int, int], int] = {}
        # key -> a completed probe's result; _pending[key] = (generation,
        # start time): the generation tells an evicted probe's late
        # result from the live probe's.
        self._results: dict[tuple[int, int], bool] = {}
        self._pending: dict[tuple[int, int], tuple[int, float]] = {}
        self._probe_gen = 0
        # key -> evicted probe threads that have not returned yet.
        self._zombies: dict[tuple[int, int], int] = {}
        self._state_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _submit_probe(self, key: tuple[int, int], disk) -> None:
        now = time.monotonic()
        with self._state_lock:
            entry = self._pending.get(key)
            if entry is not None:
                _gen, started = entry
                age = now - started
                if (age <= PROBE_PENDING_MAX_AGE_S
                        or self._zombies.get(key, 0) >= PROBE_MAX_ZOMBIES):
                    # The last probe is still in flight (or the slot's
                    # zombie budget is spent): past the timeout it counts
                    # as a failed probe each sweep, and no thread is
                    # added.
                    if age > PROBE_TIMEOUT_S:
                        self._results[key] = False
                    return
                # Evict: the old probe is a zombie. This sweep counts the
                # hang as a failed probe, then a fresh probe starts.
                self._results[key] = False
                self._zombies[key] = self._zombies.get(key, 0) + 1
            self._probe_gen += 1
            gen = self._probe_gen
            self._pending[key] = (gen, now)

        def run():
            ok = _probe(disk)
            with self._state_lock:
                cur = self._pending.get(key)
                if cur is None or cur[0] != gen:
                    # Evicted while it hung: a newer probe owns the key,
                    # and this zombie gives its budget back.
                    z = self._zombies.get(key, 0)
                    if z > 1:
                        self._zombies[key] = z - 1
                    else:
                        self._zombies.pop(key, None)
                    return
                self._results[key] = ok
                self._pending.pop(key, None)

        threading.Thread(target=run, daemon=True, name="mtpu-probe").start()

    def check_once(self, wait: bool = True) -> dict:
        """Start a probe of every drive and apply the results that are in.
        `wait` blocks up to 5 s for this round's probes; the loop passes
        False, so a hung drive never stalls it (its result applies on a
        later tick). Returns the endpoints that went offline and those
        that reconnected."""
        went_offline: list[str] = []
        reconnected: list[str] = []
        for pool in getattr(self.ol, "pools", []):
            for es in pool.sets:
                for i in range(len(es.disks)):
                    key = (id(es), i)
                    disk = es.disks[i]
                    target = disk if disk is not None else \
                        self._offline.get(key)
                    if target is None:
                        continue
                    self._submit_probe(key, target)
        if wait:
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                with self._state_lock:
                    if not self._pending:
                        break
                time.sleep(0.01)

        with self._state_lock:
            results, self._results = self._results, {}
        for pool in getattr(self.ol, "pools", []):
            for es in pool.sets:
                for i in range(len(es.disks)):
                    key = (id(es), i)
                    if key not in results:
                        continue
                    ok = results[key]
                    disk = es.disks[i]
                    if disk is not None:
                        if ok:
                            self._fails.pop(key, None)
                            continue
                        fails = self._fails.get(key, 0) + 1
                        self._fails[key] = fails
                        if fails < self.fail_threshold:
                            continue
                        self._offline[key] = disk
                        es.disks[i] = None
                        went_offline.append(disk.endpoint())
                    elif key in self._offline and ok:
                        saved = self._offline.pop(key)
                        self._fails.pop(key, None)
                        es.disks[i] = saved
                        reconnected.append(saved.endpoint())
        if reconnected and self.mrf is not None:
            # The reconnect event: drain the MRF now, so the writes the
            # drive missed heal onto it (setReconnectEvent).
            try:
                self.mrf.drain_once()
            except Exception:  # noqa: BLE001 - heal is best effort
                pass
        return {"offline": went_offline, "reconnected": reconnected}

    def start(self) -> "DiskMonitor":
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.check_once(wait=False)
                except Exception:  # noqa: BLE001 - keep monitoring
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="mtpu-disk-monitor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

"""Admin heal sequences, the port's copy of
minio_tpu/background/healseq.py (MinIO's cmd/admin-heal-ops.go
LaunchNewHealSequence / PopHealStatusJSON / stopHealSequence, and the
foreground-IO gate of cmd/background-heal-ops.go waitForLowHTTPReq).

An admin heal request starts a sequence and gets a client token back at
once; the walk and the per-object heals run on a thread of their own,
yielding to foreground requests and pausing per object; a poll with the
token takes the buffered per-object results; forceStop ends a sequence;
overlapping sequences are refused.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque

# Ended sequences linger for status polls this long, then prune
# (ref keepHealSeqStateDuration = 10 min).
KEEP_ENDED_S = 600.0
# Per-poll item budget (ref maxUnconsumedHealResultItems is 1000 buffered;
# we bound the buffer and drain it fully per poll).
MAX_BUFFERED_ITEMS = 1000


class HealOverlap(ValueError):
    """New sequence path overlaps a running one."""


class HealAlreadyRunning(ValueError):
    """Same path already has a live sequence (use forceStart)."""


class HealNoSuchSequence(KeyError):
    """Status poll for an unknown path/token."""


class HealSequence:
    """One background walk-and-heal over bucket/prefix."""

    def __init__(self, ol, bucket: str, prefix: str = "", *,
                 remove_dangling: bool = False,
                 dry_run: bool = False, io_gate=None,
                 max_sleep_s: float = 0.0):
        self.ol = ol
        self.bucket = bucket
        self.prefix = prefix
        self.token = uuid.uuid4().hex
        self.remove_dangling = remove_dangling
        self.dry_run = dry_run
        self.start_time = time.time()
        self.end_time: float | None = None
        self.status = "running"  # running | finished | stopped | failed
        self.failure: str = ""
        self.scanned = 0
        self.healed = 0
        self.failed = 0
        self._io_gate = io_gate
        self._max_sleep_s = max_sleep_s
        self._items: deque = deque(maxlen=MAX_BUFFERED_ITEMS)
        self.items_dropped = 0  # evictions between polls, never silent
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def hpath(self) -> str:
        return f"{self.bucket}/{self.prefix}".rstrip("/")

    def has_ended(self) -> bool:
        return self.status != "running"

    def start(self):
        self._thread = threading.Thread(
            target=self._run, name=f"mtpu-heal-{self.bucket}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    # --- the background walk ---

    def _run(self):
        try:
            marker = ""
            while not self._stop.is_set():
                res = self.ol.list_objects(
                    self.bucket, prefix=self.prefix, marker=marker,
                    max_keys=1000,
                )
                for oi in res.objects:
                    if self._stop.is_set():
                        break
                    self._heal_one(oi.name)
                if self._stop.is_set() or not res.is_truncated:
                    break
                marker = res.next_marker
        except Exception as exc:  # noqa: BLE001 — surfaced via status
            with self._mu:
                self.status = "failed"
                self.failure = str(exc)
                self.end_time = time.time()
            return
        with self._mu:
            self.status = "stopped" if self._stop.is_set() else "finished"
            self.end_time = time.time()

    def _heal_one(self, name: str):
        # Yield to foreground S3 traffic BEFORE each object (the
        # reference gates every background heal task the same way,
        # background-heal-ops.go:57).
        if self._io_gate is not None:
            self._io_gate(self._stop)
        self.scanned += 1
        item = {"type": "object", "bucket": self.bucket, "object": name}
        try:
            if not self.dry_run:
                self.ol.heal_object(
                    self.bucket, name,
                    remove_dangling=self.remove_dangling,
                )
            item["detail"] = "healed"
            self.healed += 1
        except Exception as exc:  # noqa: BLE001 — per-object status
            item["detail"] = "failed"
            item["error"] = str(exc)
            self.failed += 1
        with self._mu:
            if len(self._items) == self._items.maxlen:
                self.items_dropped += 1
            self._items.append(item)
        if self._max_sleep_s > 0:
            # Per-object rate limit (config heal.max_sleep): the walk
            # must never saturate a disk the foreground needs.
            self._stop.wait(self._max_sleep_s)

    # --- status ---

    def pop_status(self) -> dict:
        """Summary + buffered items; items are CONSUMED by the poll
        (ref PopHealStatusJSON)."""
        with self._mu:
            items = list(self._items)
            self._items.clear()
            return {
                "Summary": self.status,
                "StartTime": self.start_time,
                "HealSequence": self.hpath,
                "NumScanned": self.scanned,
                "NumHealed": self.healed,
                "NumFailed": self.failed,
                "FailureDetail": self.failure,
                "ItemsDropped": self.items_dropped,
                "Items": items,
            }


def make_io_gate(inflight_fn, max_io: int = 10, max_wait_s: float = 1.0,
                 tick_s: float = 0.1):
    """Build the foreground-traffic gate: while more than `max_io`
    requests are in flight, the heal wait-loops in `tick_s` steps up to
    `max_wait_s`, then proceeds anyway (exactly waitForLowHTTPReq's
    bounded backoff)."""
    if max_io <= 0 or inflight_fn is None:
        return None

    def gate(stop_event: threading.Event):
        waited = 0.0
        while inflight_fn() >= max_io and waited < max_wait_s:
            if stop_event.wait(tick_s):
                return
            waited += tick_s

    return gate


class AllHealState:
    """Registry of live + recently-ended sequences (ref allHealState)."""

    def __init__(self):
        self._seqs: dict[str, HealSequence] = {}
        self._mu = threading.Lock()

    def launch(self, ol, bucket: str, prefix: str = "", *,
               force_start: bool = False, **kw) -> HealSequence:
        seq = HealSequence(ol, bucket, prefix, **kw)
        hpath = seq.hpath
        with self._mu:
            self._prune()
            cur = self._seqs.get(hpath)
            if cur is not None and not cur.has_ended():
                if not force_start:
                    raise HealAlreadyRunning(
                        f"heal already running on {hpath}, "
                        f"token {cur.token} (use forceStart)"
                    )
                cur.stop()
            for k, s in self._seqs.items():
                if s.has_ended() or k == hpath:
                    continue
                if k.startswith(hpath) or hpath.startswith(k):
                    if not force_start:
                        raise HealOverlap(
                            f"heal path {hpath} overlaps running "
                            f"sequence {k}"
                        )
                    # forceStart supersedes overlapping sequences too
                    # (ref LaunchNewHealSequence stops and restarts).
                    s.stop()
            self._seqs[hpath] = seq
        seq.start()
        return seq

    def status(self, bucket: str, prefix: str, token: str) -> dict:
        hpath = f"{bucket}/{prefix}".rstrip("/")
        with self._mu:
            seq = self._seqs.get(hpath)
            if seq is None or seq.token != token:
                raise HealNoSuchSequence(hpath)
        return seq.pop_status()

    def stop(self, bucket: str, prefix: str = "") -> list[str]:
        """Force-stop every sequence under bucket/prefix; returns the
        stopped hpaths (ref stopHealSequence)."""
        hpath = f"{bucket}/{prefix}".rstrip("/")
        stopped = []
        with self._mu:
            for k, s in self._seqs.items():
                if not s.has_ended() and (
                    k.startswith(hpath) or hpath.startswith(k)
                ):
                    s.stop()
                    stopped.append(k)
        return stopped

    def _prune(self):
        now = time.time()
        for k in [
            k for k, s in self._seqs.items()
            if s.has_ended() and s.end_time is not None
            and now - s.end_time > KEEP_ENDED_S
        ]:
            del self._seqs[k]

"""Server-wide admission governors, the port's copy of
minio_tpu/pipeline/admission.py: the fan-in control plane.

One process-global governor decides which PUT and multipart-part encode
streams run now and which wait; a second, the read governor, does the
same for GET decode streams from its own slot pool. A FIFO semaphore
over requests lets one hot client with 50 queued uploads starve every
other client for seconds. A governor keeps the bounded-slot model and
adds:

- per-client in-flight caps: each client's concurrent streams are
  bounded by a `storage/diskcheck.DiskHealth` token budget, so one
  client takes the whole pool only when nobody else wants it;
- queue-depth-aware admission: when the queue is already `max_queue`
  deep, a new arrival is rejected at once with a retriable 503
  (MinIO's maxClients throttle, cmd/handler-api.go:36-78);
- fair scheduling: freed slots are granted round-robin across clients
  (FIFO within a client), so the Nth upload of a hot client queues
  behind the first upload of everyone else;
- telemetry: admitted, queued and rejected counters and in-flight and
  queue-depth gauges under minio_tpu's `admission_*` names, mirrored
  onto a metrics registry when one is set (the port has none yet), and
  a snapshot for tests.

Client identity flows through a contextvar set at the API dispatch (the
access key, else anonymous); internal callers (heal, harnesses) tag
themselves or share the "" client.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# client identity

_client_var: contextvars.ContextVar[str] = contextvars.ContextVar(
    "mtpu_admission_client", default=""
)
_bucket_var: contextvars.ContextVar[str] = contextvars.ContextVar(
    "mtpu_admission_bucket", default=""
)


def current_client() -> str:
    """The fairness identity for this context. Default: the access key
    alone. With MTPU_ADMISSION_TENANT=bucket the identity becomes
    (key, bucket) — one hot bucket can then no longer starve a quiet
    bucket under the SAME key, because the round-robin rotation and
    per-client caps see them as distinct tenants. The knob is read per
    call so operators can flip it without a restart."""
    client = _client_var.get()
    if os.environ.get("MTPU_ADMISSION_TENANT", "") == "bucket":
        bucket = _bucket_var.get()
        if bucket:
            return f"{client}\x1f{bucket}"
    return client


def current_bucket() -> str:
    return _bucket_var.get()


def identity() -> tuple[str, str]:
    """The raw (client, bucket) pair for this context — the carrier a
    deferred response stream captures at defer() time and reinstates
    (via client_context) when the body streams on another thread."""
    return _client_var.get(), _bucket_var.get()


@contextmanager
def client_context(client: str, bucket: str | None = None):
    """Tag every admission decision in this context with `client` (the
    API layer wraps handler dispatch; a harness wraps each simulated
    client's loop) and, when known, the request's bucket — the second
    half of the (key, bucket) tenant identity."""
    token = _client_var.set(client or "")
    btoken = (_bucket_var.set(bucket or "") if bucket is not None
              else None)
    try:
        yield
    finally:
        _client_var.reset(token)
        if btoken is not None:
            _bucket_var.reset(btoken)


# ---------------------------------------------------------------------------
# config

def _env_int(name: str, default: int, floor: int = 1) -> int:
    try:
        v = int(os.environ.get(name, ""))
    except ValueError:
        return default
    return max(floor, v)


@dataclass
class AdmissionConfig:
    """Knobs (env > default), under minio_tpu's names: `slots` is
    MTPU_MAX_CONCURRENT_ENCODES (or _DECODES), `deadline_s`
    MTPU_ENCODE_SLOT_DEADLINE_S (or MTPU_DECODE_SLOT_DEADLINE_S)."""

    slots: int = 1
    per_client_cap: int = 1
    max_queue: int = 8
    deadline_s: float = 30.0

    @classmethod
    def from_env(cls, domain: str = "put") -> "AdmissionConfig":
        # 0 (or junk) means "the cpu-count default", not one
        # serialized slot.
        cpu = max(1, os.cpu_count() or 1)
        if domain == "get":
            # Read side: GET decode+verify is lighter than
            # encode per byte and overlaps shard IO, so the default
            # admits 2 streams per core before queueing.
            slots_env, default_slots = "MTPU_MAX_CONCURRENT_DECODES", 2 * cpu
            deadline_env = "MTPU_DECODE_SLOT_DEADLINE_S"
        else:
            slots_env, default_slots = "MTPU_MAX_CONCURRENT_ENCODES", cpu
            deadline_env = "MTPU_ENCODE_SLOT_DEADLINE_S"
        try:
            slots = int(os.environ.get(slots_env, "0") or 0)
        except ValueError:
            slots = 0
        if slots <= 0:
            slots = default_slots
        # Work-conserving default: a lone client may use every slot;
        # fairness bites only when clients actually compete. Operators
        # cap hot tenants harder with MTPU_ADMISSION_CLIENT_CAP.
        cap = _env_int("MTPU_ADMISSION_CLIENT_CAP", slots)
        max_queue = _env_int("MTPU_ADMISSION_MAX_QUEUE", 8 * slots)
        try:
            deadline = float(os.environ.get(deadline_env, "30"))
        except ValueError:
            deadline = 30.0
        return cls(slots=slots, per_client_cap=min(cap, slots),
                   max_queue=max_queue, deadline_s=deadline)


# ---------------------------------------------------------------------------
# metrics

ADMISSION_DESCRIPTORS: list[tuple[str, str, str]] = [
    ("admission_admitted_total", "counter",
     "Encode streams admitted by the concurrency governor"),
    ("admission_queued_total", "counter",
     "Encode streams that waited in the admission queue"),
    ("admission_rejected_total", "counter",
     "Encode streams rejected by the governor (by reason)"),
    ("admission_inflight", "gauge",
     "Encode streams currently admitted"),
    ("admission_queue_depth", "gauge",
     "Encode streams waiting for admission"),
    ("admission_clients_waiting", "gauge",
     "Distinct clients with queued encode streams"),
    ("admission_coalesced_bypass_total", "counter",
     "GET streams served without consuming a decode slot (hot-tier "
     "cache hits and single-flight followers riding another "
     "request's admitted decode)"),
]

_metrics = None  # guarded-by: _metrics_mu
_metrics_mu = threading.Lock()


def set_metrics(registry) -> None:
    global _metrics
    with _metrics_mu:
        _metrics = registry


def _reg():
    with _metrics_mu:
        return _metrics


class _Waiter:
    __slots__ = ("client", "granted")

    def __init__(self, client: str):
        self.client = client
        self.granted = False


class AdmissionGovernor:
    """Bounded-slot admission with per-client caps and round-robin
    fairness. All state mutates under one Condition; grant decisions
    happen at release time (and at enqueue when capacity is free), so
    there is no separate scheduler thread to crash or lag."""

    def __init__(self, config: AdmissionConfig | None = None,
                 domain: str = ""):
        self.cfg = config or AdmissionConfig.from_env(domain or "put")
        # Metrics domain: "" (the PUT/encode governor, label-free as
        # in minio_tpu) or "get" (the read governor,
        # whose series carry a domain label so the two planes separate
        # on the endpoint).
        self.domain = domain
        self._cv = threading.Condition()
        self._inflight = 0                  # guarded-by: _cv
        # Per-client in-flight budgets: the diskcheck token machinery,
        # reused verbatim — DiskHealth is pure state, and its
        # acquire(0)/release/state() surface is exactly a token bucket
        # with rejection accounting.
        self._budgets: dict[str, object] = {}   # guarded-by: _cv
        # client -> FIFO of waiters; OrderedDict order IS the round-
        # robin rotation (grant pops the first eligible client, then
        # move_to_end so the next grant starts after it).
        self._queues: "OrderedDict[str, deque[_Waiter]]" = OrderedDict()  # guarded-by: _cv
        self._waiting = 0                   # guarded-by: _cv
        # Counters (module totals; mirrored onto the registry).
        self.admitted_total = 0             # guarded-by: _cv
        self.queued_total = 0               # guarded-by: _cv
        self.rejected_queue_full = 0        # guarded-by: _cv
        self.rejected_deadline = 0          # guarded-by: _cv
        # Conservation accounting (the chaos-soak invariant): every
        # acquire() arrival ends granted or rejected, so
        #   arrivals == admitted + rejected_queue_full
        #             + rejected_deadline - late_grant_returns
        # where late_grant_returns counts the deadline-loser race (the
        # grant landed while the waiter was timing out; the slot is
        # handed straight back, but both admitted and rejected were
        # incremented for that one arrival).
        self.arrivals_total = 0             # guarded-by: _cv
        self.late_grant_returns = 0         # guarded-by: _cv
        # Streams served WITHOUT a slot (hot-tier hits / coalesced
        # followers): deliberately outside the conservation identity —
        # these never arrive at the governor at all.
        self.coalesced_bypass_total = 0     # guarded-by: _cv

    # -- budgets -----------------------------------------------------------

    def _budget(self, client: str):  # guarded-by: _cv
        b = self._budgets.get(client)
        if b is None:
            from ..storage.diskcheck import DiskHealth, RobustConfig

            b = DiskHealth(endpoint=client or "anonymous",
                           config=RobustConfig(
                               max_inflight=self.cfg.per_client_cap))
            self._budgets[client] = b
        return b

    # -- grant machinery (all under self._cv) ------------------------------

    def _client_has_room(self, client: str) -> bool:  # guarded-by: _cv
        b = self._budgets.get(client)
        return b is None or b.inflight < self.cfg.per_client_cap

    def _grant_to(self, client: str) -> None:  # guarded-by: _cv
        self._inflight += 1
        # Never blocks: callers grant only after _client_has_room.
        self._budget(client).acquire(timeout_s=0.0)
        self.admitted_total += 1
        reg = _reg()
        if reg is not None:
            reg.inc("admission_admitted_total", **self._labels())

    def _grant_waiters(self) -> None:  # guarded-by: _cv
        """Hand freed capacity to queued waiters: rotate over clients,
        one grant per eligible client per pass (FIFO within a client),
        until slots run out or nobody eligible remains. The notify
        covers grants from EVERY pass — keying it on the last pass
        alone left early-pass grantees sleeping out their deadline."""
        granted_total = False
        progressed = True
        while self._inflight < self.cfg.slots and progressed:
            progressed = False
            for client in list(self._queues.keys()):
                if self._inflight >= self.cfg.slots:
                    break
                if not self._client_has_room(client):
                    continue
                q = self._queues[client]
                w = q.popleft()
                if not q:
                    del self._queues[client]
                else:
                    self._queues.move_to_end(client)
                self._waiting -= 1
                w.granted = True
                self._grant_to(client)
                progressed = True
                granted_total = True
        if granted_total:
            self._cv.notify_all()

    # -- public surface ----------------------------------------------------

    def acquire(self, client: str | None = None) -> None:
        """Admit one stream for `client`, waiting fairly up to the
        deadline. Raises ErrOperationTimedOut (a retriable 503) on a full
        queue or at the deadline. The whole admission, instant grant or
        queue wait, is one request span (kind "admission", labelled by
        the governor's domain, with "/queued" when the stream waited), so
        a stalled request's queue time shows apart from its handler's."""
        from ..observability import spans

        with spans.span("admission", self.domain or "put") as sp:
            self._acquire(client, sp)

    def _acquire(self, client: str | None, sp) -> None:
        from ..utils.errors import ErrOperationTimedOut

        if client is None:
            client = current_client()
        deadline = time.monotonic() + self.cfg.deadline_s
        with self._cv:
            self.arrivals_total += 1
            if (self._waiting == 0 and self._inflight < self.cfg.slots
                    and self._client_has_room(client)):
                self._grant_to(client)
                self._mirror_gauges()
                return
            if self._waiting >= self.cfg.max_queue:
                # Queue-depth-aware rejection: the wait could not
                # possibly be served inside any reasonable deadline, so
                # fail fast and let the client back off.
                self.rejected_queue_full += 1
                self._mirror_reject("queue_full")
                raise ErrOperationTimedOut(
                    f"server busy: admission queue full "
                    f"({self._waiting} waiting)"
                )
            w = _Waiter(client)
            self._queues.setdefault(client, deque()).append(w)
            self._waiting += 1
            self.queued_total += 1
            sp.relabel(f"{self.domain or 'put'}/queued")
            self._mirror_queued()
            # Capacity may be free right now (fast path declined only
            # because others were already waiting): run one grant pass
            # so the head of the rotation — possibly us — proceeds.
            self._grant_waiters()
            while not w.granted:
                left = deadline - time.monotonic()
                if left <= 0:
                    self._unqueue(w)
                    self.rejected_deadline += 1
                    self._mirror_reject("deadline")
                    raise ErrOperationTimedOut(
                        "server busy: PUT admission queue deadline "
                        "exceeded"
                    )
                self._cv.wait(left)
            self._mirror_gauges()

    def _unqueue(self, w: _Waiter) -> None:  # guarded-by: _cv
        q = self._queues.get(w.client)
        if q is not None:
            try:
                q.remove(w)
                self._waiting -= 1
            except ValueError:
                pass  # granted between timeout check and removal
            if not q:
                self._queues.pop(w.client, None)
        if w.granted:
            # Lost the race: the grant landed while we were timing out.
            # Hand the slot straight back so it is not leaked.
            self.late_grant_returns += 1
            self._release_locked(w.client)

    def release(self, client: str | None = None) -> None:
        if client is None:
            client = current_client()
        with self._cv:
            self._release_locked(client)
            self._mirror_gauges()

    def _release_locked(self, client: str) -> None:  # guarded-by: _cv
        self._inflight = max(0, self._inflight - 1)
        b = self._budgets.get(client)
        if b is not None and b.inflight > 0:
            b.release()
        # Idle budgets are evicted: client ids are access keys, and a
        # deployment minting ephemeral STS keys must not accrete one
        # token bucket per key forever.
        if b is not None and b.inflight == 0 and client not in self._queues:
            self._budgets.pop(client, None)
        self._grant_waiters()

    def note_coalesced(self) -> None:
        """Record one stream served without consuming a slot (the
        hot-object tier's cache hits and single-flight followers), so
        the slot-pressure dashboards can see demand the pool never had
        to absorb."""
        with self._cv:
            self.coalesced_bypass_total += 1
        reg = _reg()
        if reg is not None:
            reg.inc("admission_coalesced_bypass_total", **self._labels())

    def saturated(self) -> bool:
        """True when a fresh acquire would reject IMMEDIATELY (queue
        already full). The pre-status probe for streaming responses:
        once the status line is on the wire a rejection can only sever
        the connection, so handlers ask this BEFORE committing to a
        200 and turn the documented fast-fail into a real 503. Must
        mirror acquire()'s ordering: the fast path admits BEFORE the
        queue-depth check, so an idle governor is never saturated even
        under a max_queue=0 (no-queueing) config."""
        with self._cv:
            if self._waiting == 0 and self._inflight < self.cfg.slots:
                return False  # acquire()'s fast path would admit
            return self._waiting >= self.cfg.max_queue

    @contextmanager
    def slot(self, client: str | None = None):
        if client is None:
            client = current_client()
        self.acquire(client)
        try:
            yield
        finally:
            self.release(client)

    # -- introspection -----------------------------------------------------

    def backlog(self) -> int:
        """Current queue depth — the heal pacer's foreground-pressure
        probe. Lock-free: a momentarily stale depth only shifts WHEN a
        heal yields, never correctness."""
        # guardedby-ok: racy telemetry read of an int the CPython VM
        # loads atomically; staleness is bounded by one grant cycle
        return self._waiting

    def snapshot(self) -> dict:
        with self._cv:
            return {
                "slots": self.cfg.slots,
                "inflight": self._inflight,
                "waiting": self._waiting,
                "clients_waiting": len(self._queues),
                "admitted_total": self.admitted_total,
                "queued_total": self.queued_total,
                "rejected_queue_full": self.rejected_queue_full,
                "rejected_deadline": self.rejected_deadline,
                "arrivals_total": self.arrivals_total,
                "late_grant_returns": self.late_grant_returns,
                "coalesced_bypass_total": self.coalesced_bypass_total,
                "per_client_inflight": {
                    c: b.inflight for c, b in self._budgets.items()
                    if b.inflight
                },
            }

    # -- metrics mirroring (no-ops without a registry) ---------------------

    def _labels(self) -> dict:
        return {"domain": self.domain} if self.domain else {}

    def _mirror_gauges(self) -> None:  # guarded-by: _cv
        reg = _reg()
        if reg is None:
            return
        lb = self._labels()
        reg.set_gauge("admission_inflight", self._inflight, **lb)
        reg.set_gauge("admission_queue_depth", self._waiting, **lb)
        reg.set_gauge("admission_clients_waiting", len(self._queues), **lb)

    def _mirror_queued(self) -> None:  # guarded-by: _cv
        reg = _reg()
        if reg is not None:
            lb = self._labels()
            reg.inc("admission_queued_total", **lb)
            reg.set_gauge("admission_queue_depth", self._waiting, **lb)

    def _mirror_reject(self, reason: str) -> None:
        reg = _reg()
        if reg is not None:
            reg.inc("admission_rejected_total", reason=reason,
                    **self._labels())


# ---------------------------------------------------------------------------
# process-global instance

_governor: AdmissionGovernor | None = None  # guarded-by: _governor_mu
_governor_mu = threading.Lock()


def governor() -> AdmissionGovernor:
    global _governor
    # guardedby-ok: double-checked fast path — a stale None read just
    # falls through to the locked check; the reference write is atomic
    g = _governor
    if g is None:
        with _governor_mu:
            if _governor is None:
                _governor = AdmissionGovernor()
            g = _governor
    return g


def reconfigure(config: AdmissionConfig | None = None) -> AdmissionGovernor:
    """Swap the process governor (server boot after config load; tests).
    Streams admitted under the old instance release against it — their
    context managers hold the old object — so the swap is safe while
    traffic is in flight."""
    global _governor
    with _governor_mu:
        _governor = AdmissionGovernor(config)
        return _governor


# The read-side governor: GET decode streams take their
# slots here, NEVER from the encode governor — the two planes must not
# be able to 503 each other, and a copy/select request that reads while
# its write side holds an encode slot can never self-deadlock across
# two independent slot pools with deadlines.

_read_governor: AdmissionGovernor | None = None  # guarded-by: _read_governor_mu
_read_governor_mu = threading.Lock()


def read_governor() -> AdmissionGovernor:
    global _read_governor
    # guardedby-ok: double-checked fast path — a stale None read just
    # falls through to the locked check; the reference write is atomic
    g = _read_governor
    if g is None:
        with _read_governor_mu:
            if _read_governor is None:
                _read_governor = AdmissionGovernor(
                    AdmissionConfig.from_env("get"), domain="get"
                )
            g = _read_governor
    return g


def reconfigure_read(
    config: AdmissionConfig | None = None,
) -> AdmissionGovernor:
    global _read_governor
    with _read_governor_mu:
        _read_governor = AdmissionGovernor(
            config or AdmissionConfig.from_env("get"), domain="get"
        )
        return _read_governor

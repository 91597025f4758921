"""The byte-flow ledger, the port's copy of minio_tpu/observability/
ioflow.py: every disk byte the drives move, attributed to the op class
that moved it, so "the disks moved 40 GB" becomes "heal read 12 bytes
for every byte it repaired".

- Op tag: a contextvar holding a small mutable `_OpTag` (op class and
  bucket), set at the S3 dispatch (api/server.py maps the routed API to
  one of OP_CLASSES) and at the background services' entry points (the
  heal choke point `ErasureObjects.heal_object`, the scanner's cycle,
  the MRF drain). Fan-out, reader, stage and per-drive pool threads
  take it over through `carry` (observability.carry binds the span
  trace with it). The holder is shared by a request's threads, so a
  degraded GET is reclassified mid-stream: the reader that sees a
  missing or corrupt shard calls `retag_degraded()` and every later
  byte of the stream, in whichever thread, counts as `get-degraded`.
- Per-thread counters: `account(drive, dir, n)` adds into the calling
  thread's own dict keyed (drive, op, dir), with no lock; `snapshot()`
  sums the threads' views (totals are monotonic, so a torn read
  undercounts by at most the op in flight). A recycled thread ident
  reuses its block.
- Directions: `read`/`write` are shard and payload bytes (bitrot
  framing included), `rmeta`/`wmeta` metadata bytes (xl.meta, small
  blobs, listings), kept apart so the repair ratios stay data-plane.
- Logical bytes: `logical(n)` counts payload bytes per op class (bytes
  served to a GET client, source bytes of a committed PUT or part), the
  denominators of the amplification series.
- Hot buckets: every data-plane `account()` feeds the tag's bucket into
  a space-saving top-K sketch (Metwally et al.), flushed per thread at
  a context's exit.

`efficiency()` derives heal_bytes_read_per_byte_healed (heal read over
heal write: k for a dense heal of one shard),
degraded_get_read_amplification and scan_bytes_per_object; `report()`
is the admin ioflow answer. MTPU_IOFLOW=0 (or off, false, no) disarms
the ledger, re-read at every `tag()` entry.
"""

from __future__ import annotations

import contextvars
import os
import threading

# Series contributed to the metrics_v2 descriptor catalog.
IOFLOW_DESCRIPTORS: list[tuple[str, str, str]] = [
    ("ioflow_bytes_total", "counter",
     "Disk bytes moved by drive, op-class and dir (read/write = shard "
     "data incl. bitrot framing, rmeta/wmeta = metadata)"),
    ("ioflow_logical_bytes_total", "counter",
     "Payload-level bytes by op-class (bytes served to GET clients, "
     "source bytes of committed PUTs/parts)"),
    ("heal_bytes_read_per_byte_healed", "gauge",
     "Survivor bytes read per byte repaired (== k for dense RS "
     "single-shard heal; (n-1)/m for the msr-pm repair plane)"),
    ("repair_wire_bytes_per_byte_healed", "gauge",
     "Remote repair-symbol bytes received over storage-REST per byte "
     "repaired (the repair plane ships beta-slices, not shards; 0 "
     "when every survivor is local)"),
    ("degraded_get_read_amplification", "gauge",
     "Disk bytes read per byte served on degraded GETs"),
    ("scan_bytes_per_object", "gauge",
     "Scanner disk bytes (data + metadata) per object visited"),
    ("hot_bucket_bytes_total", "counter",
     "Approximate data-plane bytes by bucket (space-saving top-K "
     "sketch; `overcount` bounds the error)"),
    ("ioflow_served_bytes_total", "counter",
     "GET payload bytes served by the hot-object tier, by class "
     "(hit = decoded-block cache, coalesced = follower slicing a "
     "shared in-flight decode); bytes absent from the series were "
     "served by a private decode pipeline"),
]

# The op classes. Anything the dispatch map doesn't name
# lands in "other"; IO outside any tag context is "untagged".
OP_CLASSES = ("put", "get", "get-degraded", "heal", "scan", "list",
              "multipart", "replication", "other", "untagged")

# Per-thread hot-bucket pending map bound: flush to the shared sketch
# past this many distinct buckets (context exit flushes the rest).
_HOT_PENDING_MAX = 64


def enabled() -> bool:
    """Read at tag() entry so tests/operators flip the plane without a
    restart (the convention of MTPU_TRACE)."""
    return os.environ.get("MTPU_IOFLOW", "1").lower() not in (
        "0", "off", "false", "no"
    )


# Cheap hot-path switch: initialized from the env at import and
# refreshed at every tag() entry, read as a plain module global by
# account() — a boot-time MTPU_IOFLOW=0 silences even untagged startup
# IO. guardedby-ok: racy read/write of an atomically-rebound bool —
# one request of lag when the knob flips, never corruption.
_armed = enabled()


class _OpTag:
    """Mutable op holder shared by every thread serving one request —
    mutating `op` reclassifies the stream's remaining bytes (the
    degraded-GET promotion)."""

    __slots__ = ("op", "bucket")

    def __init__(self, op: str, bucket: str = ""):
        self.op = op
        self.bucket = bucket


_op_var: contextvars.ContextVar = contextvars.ContextVar(
    "mtpu_ioflow_op", default=None
)


def current_op() -> str:
    t = _op_var.get()
    return t.op if t is not None else "untagged"


def retag(op: str) -> None:
    """Reclassify the CURRENT tag in place (all threads sharing the
    holder see it instantly); no-op outside a tag context."""
    t = _op_var.get()
    if t is not None:
        t.op = op


def retag_degraded() -> None:
    """Promote a plain GET to get-degraded the moment a missing or
    corrupt shard is observed (called from ParallelReader's fetch
    threads). Ops other than GET keep their class — a heal also sees
    missing shards; that is its job, not degradation."""
    t = _op_var.get()
    if t is not None and t.op == "get":
        t.op = "get-degraded"


# ---------------------------------------------------------------------------
# per-thread counters

class _Counters:
    __slots__ = ("bytes", "logical", "hot", "served")

    def __init__(self):
        self.bytes: dict[tuple, int] = {}   # (drive, op, dir) -> n
        self.logical: dict[str, int] = {}   # op -> n
        self.hot: dict[str, int] = {}       # bucket -> pending bytes
        self.served: dict[str, int] = {}    # class -> n (readtier)


_tls = threading.local()
_all: dict[int, _Counters] = {}  # thread ident -> block  # guarded-by: _all_mu
_all_mu = threading.Lock()


def _counters() -> _Counters:
    try:
        return _tls.c
    except AttributeError:
        ident = threading.get_ident()
        with _all_mu:
            c = _all.get(ident)
            if c is None:
                # A recycled ident means its previous thread is dead:
                # reuse the block (bounds the registry at peak thread
                # count, exactly like the span rings).
                c = _Counters()
                _all[ident] = c
        _tls.c = c
        return c


def account(drive: str, dir_: str, n: int) -> None:
    """Hot path: attribute `n` disk bytes on `drive` to the current
    op-class. dir_ is one of read/write/rmeta/wmeta (rwire, the repair
    symbols a node receives over storage-REST, has no caller in the
    port: its distributed planes are not ported)."""
    if not _armed or n <= 0:
        return
    t = _op_var.get()
    op = t.op if t is not None else "untagged"
    c = _counters()
    key = (drive, op, dir_)
    b = c.bytes
    b[key] = b.get(key, 0) + n
    if t is not None and t.bucket and dir_ in ("read", "write"):
        hot = c.hot
        hot[t.bucket] = hot.get(t.bucket, 0) + n
        if len(hot) > _HOT_PENDING_MAX:
            _flush_hot(c)


def logical(n: int) -> None:
    """Payload-level bytes for the current op-class (e.g. bytes served
    to the GET client) — the read-amplification denominator."""
    if not _armed or n <= 0:
        return
    t = _op_var.get()
    op = t.op if t is not None else "untagged"
    c = _counters()
    c.logical[op] = c.logical.get(op, 0) + n


def served(kind: str, n: int) -> None:
    """Payload bytes the hot-object read tier served without a private
    decode: `kind` is "hit" (decoded-block cache) or "coalesced"
    (follower slicing a shared in-flight decode). The port has no read
    tier yet, so nothing calls it and the series stays empty."""
    if not _armed or n <= 0:
        return
    c = _counters()
    c.served[kind] = c.served.get(kind, 0) + n


def _flush_hot(c: _Counters) -> None:
    if not c.hot:
        return
    pending, c.hot = c.hot, {}
    sk = _hot_sketch()
    with _hot_mu:
        for bucket, n in pending.items():
            sk.offer(bucket, n)


# ---------------------------------------------------------------------------
# tag context + cross-thread carriers

class tag:
    """Set the op-class (and bucket) for the duration of the block.
    Nested tags shadow (a heal fired under a scan cycle counts as
    heal); the outer tag is restored on exit."""

    __slots__ = ("_op", "_bucket", "_tok")

    def __init__(self, op: str, bucket: str = ""):
        self._op = op
        self._bucket = bucket

    def __enter__(self) -> "_OpTag | None":
        global _armed
        _armed = enabled()
        if not _armed:
            self._tok = None
            return None
        holder = _OpTag(self._op, self._bucket)
        self._tok = _op_var.set(holder)
        return holder

    def __exit__(self, *exc):
        if self._tok is not None:
            _op_var.reset(self._tok)
            _flush_hot(_counters())
        return False


def capture():
    """Snapshot the current tag holder for handing to another thread
    (same shape as spans.capture); None when untagged."""
    return _op_var.get()


class activate:
    """Install a captured tag holder in the current thread for the
    duration of the block; no-op for a None carrier. The HOLDER is
    shared, not copied — a retag from any thread reclassifies all."""

    __slots__ = ("_holder", "_tok")

    def __init__(self, holder):
        self._holder = holder

    def __enter__(self):
        self._tok = (_op_var.set(self._holder)
                     if self._holder is not None else None)
        return self

    def __exit__(self, *exc):
        if self._tok is not None:
            _op_var.reset(self._tok)
            _flush_hot(_counters())
        return False


def bound(holder, fn):
    """Wrap `fn` so it runs under the captured tag — the shape fan-out
    code submits to thread pools."""
    if holder is None:
        return fn

    def run(*args, **kwargs):
        with activate(holder):
            return fn(*args, **kwargs)

    return run


def carry(fn):
    """`fn` bound to the calling thread's tag, for a pool submit or a
    thread target; `fn` itself when untagged."""
    return bound(_op_var.get(), fn)


# ---------------------------------------------------------------------------
# space-saving top-K hot-bucket sketch

class SpaceSaving:
    """Metwally et al. space-saving heavy hitters over byte weights:
    K counters total. A key not tracked evicts the minimum counter and
    inherits its count (recorded as the new entry's `overcount` error
    bound). Guarded externally by _hot_mu."""

    __slots__ = ("k", "counts", "errors")

    def __init__(self, k: int):
        self.k = max(1, k)
        self.counts: dict[str, int] = {}
        self.errors: dict[str, int] = {}

    def offer(self, key: str, weight: int) -> None:
        counts = self.counts
        if key in counts:
            counts[key] += weight
            return
        if len(counts) < self.k:
            counts[key] = weight
            self.errors[key] = 0
            return
        victim = min(counts, key=counts.get)
        floor = counts.pop(victim)
        self.errors.pop(victim, None)
        counts[key] = floor + weight
        self.errors[key] = floor

    def top(self, n: int | None = None) -> list[dict]:
        items = sorted(self.counts.items(), key=lambda kv: -kv[1])
        if n is not None:
            items = items[:n]
        return [
            {"bucket": k, "bytes": v, "overcount": self.errors.get(k, 0)}
            for k, v in items
        ]


_hot = None  # guarded-by: _hot_mu (rebound only under it)
_hot_mu = threading.Lock()


def _topk() -> int:
    try:
        return int(os.environ.get("MTPU_IOFLOW_TOPK", "32"))
    except ValueError:
        return 32


def _hot_sketch() -> SpaceSaving:
    global _hot
    # guardedby-ok: double-checked fast path — a stale None read
    # falls through to the locked re-check below
    sk = _hot
    if sk is None:
        with _hot_mu:
            if _hot is None:
                _hot = SpaceSaving(_topk())
            sk = _hot
    return sk


def hot_buckets(n: int | None = None) -> list[dict]:
    """Top-N hot buckets by approximate data-plane bytes, hottest
    first. Flushes only the CALLING thread's pending deltas; other
    threads' tails land at their context exits."""
    _flush_hot(_counters())
    with _hot_mu:
        if _hot is None:
            return []
        return _hot.top(n)


# ---------------------------------------------------------------------------
# snapshot + derived efficiency series

def snapshot() -> dict:
    """Aggregate every thread's counters: {"bytes": {(drive, op, dir):
    n}, "logical": {op: n}}. Monotonic totals — safe to diff across
    calls (the bench A/B and the e2e reconciliation test do)."""
    with _all_mu:
        blocks = list(_all.values())
    bytes_total: dict[tuple, int] = {}
    logical_total: dict[str, int] = {}
    served_total: dict[str, int] = {}
    for c in blocks:
        # Racy reads of single-writer dicts: list() the items under the
        # GIL; a concurrent insert is simply not yet visible.
        for key, n in list(c.bytes.items()):
            bytes_total[key] = bytes_total.get(key, 0) + n
        for op, n in list(c.logical.items()):
            logical_total[op] = logical_total.get(op, 0) + n
        for kind, n in list(c.served.items()):
            served_total[kind] = served_total.get(kind, 0) + n
    return {"bytes": bytes_total, "logical": logical_total,
            "served": served_total}


def op_totals(snap: dict | None = None) -> dict:
    """{op: {dir: bytes}} rollup across drives."""
    snap = snap or snapshot()
    out: dict[str, dict[str, int]] = {}
    for (_drive, op, dir_), n in snap["bytes"].items():
        out.setdefault(op, {})[dir_] = out.get(op, {}).get(dir_, 0) + n
    return out


def efficiency(snap: dict | None = None,
               scan_objects: int = 0) -> dict:
    """The derived series. Ratios are None until both sides of a
    fraction have moved (exporters skip None — a 0/0 gauge would read
    as 'perfectly efficient')."""
    snap = snap or snapshot()
    ops = op_totals(snap)

    def ratio(num, den):
        return round(num / den, 4) if num and den else None

    heal = ops.get("heal", {})
    deg = ops.get("get-degraded", {})
    scan = ops.get("scan", {})
    logical_deg = snap["logical"].get("get-degraded", 0)
    return {
        "heal_bytes_read_per_byte_healed": ratio(
            heal.get("read", 0), heal.get("write", 0)),
        "repair_wire_bytes_per_byte_healed": ratio(
            heal.get("rwire", 0), heal.get("write", 0)),
        "degraded_get_read_amplification": ratio(
            deg.get("read", 0), logical_deg),
        "scan_bytes_per_object": ratio(
            scan.get("read", 0) + scan.get("rmeta", 0), scan_objects),
    }


def report(scan_objects: int = 0) -> dict:
    """The admin/v3/ioflow payload: nested ledger + derived series +
    hot buckets."""
    snap = snapshot()
    nested: dict = {}
    for (drive, op, dir_), n in sorted(snap["bytes"].items()):
        nested.setdefault(op, {}).setdefault(drive, {})[dir_] = n
    return {
        "bytes": nested,
        "opTotals": op_totals(snap),
        "logicalBytes": snap["logical"],
        "servedBytes": snap["served"],
        "efficiency": efficiency(snap, scan_objects=scan_objects),
        "hotBuckets": hot_buckets(),
    }


def reset() -> None:
    """Test hook: zero every thread's counters and the sketch (never
    called on a serving path)."""
    global _hot
    with _all_mu:
        for c in _all.values():
            c.bytes = {}
            c.logical = {}
            c.hot = {}
            c.served = {}
    with _hot_mu:
        _hot = None

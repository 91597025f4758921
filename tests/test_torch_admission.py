"""The admission governors (pipeline/admission.py, the encode and decode
slots of utils/fanout.py) of the port against minio_tpu's.

Each case runs one script on both packages and compares the grant
orders, the rejections (by exception class name) and the governors'
snapshots. The cases of tests/test_admission.py come first, all but its
metrics-v2 catalog case (the port has no metrics endpoint yet); then a
seeded script of acquires and releases, a threaded run of the
conservation identity, the slots that put_object, put_object_part and
get_object take, and the S3 servers of both packages over HTTP: a GET's
decode slot charged to its caller through the body stream, 503 SlowDown
for a GET while the read governor is saturated, and for the PUTs past a
full encode queue.
"""

import contextlib
import io
import os
import sys
import threading
import time
import types

import numpy as np
import pytest

from minio_tpu.api import S3Server as JaxS3Server
from minio_tpu.bucket import BucketMetadataSys as JaxBucketMetadataSys
from minio_tpu.iam import IAMSys as JaxIAMSys
from minio_tpu.object import erasure_objects as jax_eo
from minio_tpu.object.pools import ErasureServerPools as JaxPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.pipeline import admission as jax_admission
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu.utils import errors as jax_errors
from minio_tpu.utils import fanout as jax_fanout
from minio_tpu_torch.api.client import S3Client
from minio_tpu_torch.api.server import S3Server
from minio_tpu_torch.bucket.metadata import BucketMetadataSys
from minio_tpu_torch.iam.store import IAMSys
from minio_tpu_torch.object import erasure_objects
from minio_tpu_torch.object.pools import ErasureServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.pipeline import admission
from minio_tpu_torch.storage.local import LocalStorage
from minio_tpu_torch.utils import errors, fanout

PORT, JAX = "port", "jax"
PKG = {
    PORT: types.SimpleNamespace(adm=admission, fanout=fanout,
                                errors=errors, eo=erasure_objects),
    JAX: types.SimpleNamespace(adm=jax_admission, fanout=jax_fanout,
                               errors=jax_errors, eo=jax_eo),
}
ACCESS, SECRET = "tpuadmin", "tpuadmin-secret-key"
BUCKET = "bkt"
SMALL_BLOCK = 12 * 1024


@pytest.fixture(autouse=True)
def _fresh_governors():
    yield
    # Cases swap the process governors: restore the env-derived ones.
    for p in PKG.values():
        p.adm.reconfigure()
        p.adm.reconfigure_read()
        p.adm.set_metrics(None)


def _cfg(pkg, **kw):
    return PKG[pkg].adm.AdmissionConfig(**kw)


def _gov(pkg, **kw):
    return PKG[pkg].adm.AdmissionGovernor(_cfg(pkg, **kw))


def _err(pkg, fn) -> str | None:
    try:
        fn()
    except PKG[pkg].errors.ErrOperationTimedOut as exc:
        return type(exc).__name__
    return None


def _both(script, *args, **kwargs):
    """script(pkg, ...) on both packages; the port's result, after
    asserting it equals minio_tpu's."""
    got = script(PORT, *args, **kwargs)
    want = script(JAX, *args, **kwargs)
    assert got == want
    return got


def _ordered(g, runs, settle_s: float = 0.05):
    """Start each (tag, client) waiter on `g` in order (each one queued
    before the next starts), release the "holder", and return the grant
    order by tag."""
    order: list[str] = []
    order_mu = threading.Lock()
    threads = []
    for tag, client, ctx in runs:
        ev = threading.Event()

        def body(tag=tag, client=client, ctx=ctx, ev=ev):
            with ctx():
                ev.set()
                c = client()
                g.acquire(c)
                with order_mu:
                    order.append(tag)
                g.release(c)

        t = threading.Thread(target=body)
        t.start()
        ev.wait()
        time.sleep(settle_s)  # deterministic enqueue order
        threads.append(t)
    g.release("holder")
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    return order


# ---------------------------------------------------------------------------
# the cases of tests/test_admission.py


def _fast_path(pkg):
    g = _gov(pkg, slots=2, per_client_cap=2, max_queue=4, deadline_s=1.0)
    with g.slot("a"):
        with g.slot("b"):
            inner = g.snapshot()
    return inner, g.snapshot()


def test_fast_path_admits_without_queueing():
    inner, snap = _both(_fast_path)
    assert inner["inflight"] == 2 and inner["queued_total"] == 0
    assert snap["inflight"] == 0 and snap["admitted_total"] == 2


def _round_robin(pkg):
    g = _gov(pkg, slots=1, per_client_cap=1, max_queue=8, deadline_s=10.0)
    g.acquire("holder")
    runs = [(t, (lambda c=c: c), contextlib.nullcontext) for t, c in (
        ("hot1", "hot"), ("hot2", "hot"), ("hot3", "hot"),
        ("cold1", "cold"))]
    return _ordered(g, runs), g.snapshot()


def test_round_robin_across_clients_fifo_within():
    """One hot client with 3 queued streams must not starve a second
    client: hot1, cold1, hot2, hot3."""
    order, snap = _both(_round_robin)
    assert order == ["hot1", "cold1", "hot2", "hot3"]
    assert snap["admitted_total"] == 5 and snap["queued_total"] == 4


def _cap(pkg):
    g = _gov(pkg, slots=4, per_client_cap=2, max_queue=8, deadline_s=0.1)
    g.acquire("hot")
    g.acquire("hot")
    over = _err(pkg, lambda: g.acquire("hot"))
    cold = _err(pkg, lambda: g.acquire("cold"))
    snap = g.snapshot()
    for c in ("hot", "hot", "cold"):
        g.release(c)
    return over, cold, snap


def test_per_client_cap_binds_only_the_hot_client():
    over, cold, snap = _both(_cap)
    assert over == "ErrOperationTimedOut" and cold is None
    assert snap["rejected_deadline"] == 1
    assert snap["per_client_inflight"] == {"hot": 2, "cold": 1}


def _queue_full(pkg):
    g = _gov(pkg, slots=1, per_client_cap=1, max_queue=1, deadline_s=5.0)
    g.acquire("a")
    waiter_in = threading.Event()
    out = {}

    def waiter():
        waiter_in.set()
        out["waiter"] = _err(pkg, lambda: (g.acquire("b"), g.release("b")))

    t = threading.Thread(target=waiter)
    t.start()
    waiter_in.wait()
    deadline = time.monotonic() + 2.0
    while g.snapshot()["waiting"] < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    t0 = time.monotonic()
    rejected = _err(pkg, lambda: g.acquire("c"))
    fast = time.monotonic() - t0 < 1.0
    g.release("a")
    t.join(timeout=5)
    return rejected, fast, out["waiter"], g.snapshot()


def test_queue_full_rejects_immediately():
    rejected, fast, waiter, snap = _both(_queue_full)
    assert rejected == "ErrOperationTimedOut" and fast and waiter is None
    assert snap["rejected_queue_full"] == 1 and snap["admitted_total"] == 2


def _encode_slot(pkg):
    p = PKG[pkg]
    g = p.adm.reconfigure(_cfg(pkg, slots=1, per_client_cap=1, max_queue=4,
                               deadline_s=0.05))
    g.acquire("occupant")
    try:
        def use():
            with p.fanout.encode_slot():
                pass
        refused = _err(pkg, use)
    finally:
        g.release("occupant")
    with p.fanout.encode_slot():
        inflight = g.snapshot()["inflight"]
    return refused, inflight, g.snapshot()


def test_encode_slot_rides_the_governor():
    """utils/fanout.encode_slot is the governor's front door: a held slot
    and a tiny deadline turn the next PUT admission into a 503."""
    refused, inflight, snap = _both(_encode_slot)
    assert refused == "ErrOperationTimedOut" and inflight == 1
    assert snap["rejected_deadline"] == 1


def _tenant(pkg, monkeypatch):
    adm = PKG[pkg].adm
    monkeypatch.setenv("MTPU_ADMISSION_TENANT", "bucket")
    g = _gov(pkg, slots=1, per_client_cap=1, max_queue=8, deadline_s=10.0)
    g.acquire("holder")
    runs = [(t, adm.current_client,
             (lambda b=b: adm.client_context("one-key", bucket=b)))
            for t, b in (("hot1", "hot-bucket"), ("hot2", "hot-bucket"),
                         ("hot3", "hot-bucket"), ("quiet1", "quiet-bucket"))]
    order = _ordered(g, runs)
    monkeypatch.delenv("MTPU_ADMISSION_TENANT")
    with adm.client_context("one-key", bucket="hot-bucket"):
        pooled = adm.current_client()
    return order, pooled


def test_bucket_tenant_identity_unstarves_quiet_bucket(monkeypatch):
    """With MTPU_ADMISSION_TENANT=bucket a hot bucket cannot starve a
    quiet bucket of the same key; without it the key is one identity."""
    order, pooled = _both(_tenant, monkeypatch)
    assert order == ["hot1", "quiet1", "hot2", "hot3"]
    assert pooled == "one-key"


class FakeRegistry:
    def __init__(self):
        self.counts: dict = {}
        self.gauges: dict = {}

    def inc(self, name, n=1, **labels):
        key = (name, tuple(sorted(labels.items())))
        self.counts[key] = self.counts.get(key, 0) + n

    def set_gauge(self, name, value, **labels):
        self.gauges[(name, tuple(sorted(labels.items())))] = value


def _read_separate(pkg):
    p = PKG[pkg]
    reg = FakeRegistry()
    p.adm.set_metrics(reg)
    rg = p.adm.reconfigure_read(_cfg(pkg, slots=1, per_client_cap=1,
                                     max_queue=0, deadline_s=0.05))
    eg = p.adm.reconfigure(_cfg(pkg, slots=1, per_client_cap=1,
                                max_queue=4, deadline_s=0.05))
    eg.acquire("writer")  # the encode plane saturated...
    try:
        with p.fanout.decode_slot():  # ...reads still flow
            inside = (rg.snapshot()["inflight"], eg.snapshot()["inflight"])
            refused = _err(pkg, lambda: rg.acquire("b"))
    finally:
        eg.release("writer")
    return inside, refused, rg.snapshot(), reg.counts, reg.gauges


def test_read_governor_is_separate_and_labeled():
    inside, refused, snap, counts, _ = _both(_read_separate)
    assert inside == (1, 1) and refused == "ErrOperationTimedOut"
    assert snap["inflight"] == 0
    assert counts[("admission_admitted_total", (("domain", "get"),))] == 1
    assert counts[("admission_rejected_total",
                   (("domain", "get"), ("reason", "queue_full")))] == 1
    assert counts[("admission_admitted_total", ())] == 1


def _saturated(pkg):
    g = _gov(pkg, slots=1, per_client_cap=1, max_queue=1, deadline_s=5.0)
    seen = [g.saturated()]
    g.acquire("a")
    seen.append(g.saturated())
    waiter_in = threading.Event()

    def waiter():
        waiter_in.set()
        g.acquire("b")
        g.release("b")

    t = threading.Thread(target=waiter)
    t.start()
    waiter_in.wait()
    deadline = time.monotonic() + 2.0
    while not g.saturated() and time.monotonic() < deadline:
        time.sleep(0.005)
    seen.append(g.saturated())
    g.release("a")
    t.join(timeout=5)
    seen.append(g.saturated())
    return seen


def test_saturated_probe_matches_queue_full():
    """saturated() flips exactly when a fresh acquire would be refused at
    once, so a GET's 503 goes out before its status line."""
    assert _both(_saturated) == [False, False, True, False]


def _reentry(pkg):
    adm = PKG[pkg].adm
    seen = []
    for tenant in (None, "bucket"):
        if tenant:
            os.environ["MTPU_ADMISSION_TENANT"] = tenant
        try:
            with adm.client_context("ak", bucket="b1"):
                caller = adm.current_client()
                ident = adm.identity()
            outside = adm.current_client()
            with adm.client_context(caller):  # the stream closure
                again = adm.current_client()
            with adm.client_context(*ident):  # the dispatch's carrier
                carried = adm.current_client()
            seen.append((caller, outside, again, carried, ident))
        finally:
            os.environ.pop("MTPU_ADMISSION_TENANT", None)
    return seen


def test_identity_survives_stream_closure_reentry():
    seen = _both(_reentry)
    assert seen == [("ak", "", "ak", "ak", ("ak", "b1")),
                    ("ak\x1fb1", "", "ak\x1fb1", "ak\x1fb1", ("ak", "b1"))]


def _read_defaults(pkg, monkeypatch):
    adm = PKG[pkg].adm
    monkeypatch.delenv("MTPU_MAX_CONCURRENT_DECODES", raising=False)
    monkeypatch.delenv("MTPU_DECODE_SLOT_DEADLINE_S", raising=False)
    first = vars(adm.AdmissionConfig.from_env("get")).copy()
    monkeypatch.setenv("MTPU_MAX_CONCURRENT_DECODES", "7")
    monkeypatch.setenv("MTPU_DECODE_SLOT_DEADLINE_S", "3.5")
    monkeypatch.setenv("MTPU_ADMISSION_CLIENT_CAP", "3")
    monkeypatch.setenv("MTPU_ADMISSION_MAX_QUEUE", "11")
    second = vars(adm.AdmissionConfig.from_env("get")).copy()
    monkeypatch.setenv("MTPU_MAX_CONCURRENT_ENCODES", "5")
    monkeypatch.setenv("MTPU_ENCODE_SLOT_DEADLINE_S", "9")
    put = vars(adm.AdmissionConfig.from_env("put")).copy()
    for k in ("MTPU_ADMISSION_CLIENT_CAP", "MTPU_ADMISSION_MAX_QUEUE",
              "MTPU_MAX_CONCURRENT_ENCODES", "MTPU_ENCODE_SLOT_DEADLINE_S"):
        monkeypatch.delenv(k)
    return first, second, put


def test_read_config_defaults(monkeypatch):
    """Read slots default to 2 a core and read their own knobs; the
    shared knobs (client cap, queue) bind both domains."""
    first, second, put = _both(_read_defaults, monkeypatch)
    cpu = max(1, os.cpu_count() or 1)
    assert first["slots"] == 2 * cpu and first["deadline_s"] == 30.0
    assert second == {"slots": 7, "per_client_cap": 3, "max_queue": 11,
                      "deadline_s": 3.5}
    assert put == {"slots": 5, "per_client_cap": 3, "max_queue": 11,
                   "deadline_s": 9.0}


def _client_context(pkg):
    adm = PKG[pkg].adm
    g = adm.reconfigure(_cfg(pkg, slots=2, per_client_cap=1, max_queue=4,
                             deadline_s=0.05))
    with adm.client_context("tenant-a"):
        g.acquire()
        inside = g.snapshot()["per_client_inflight"]
        refused = _err(pkg, g.acquire)  # same client, cap 1
        g.release()
    return inside, refused, g.snapshot()


def test_client_context_tags_the_caller():
    inside, refused, snap = _both(_client_context)
    assert inside == {"tenant-a": 1} and refused == "ErrOperationTimedOut"
    assert snap["inflight"] == 0


def _capped_wake(pkg):
    g = _gov(pkg, slots=8, per_client_cap=2, max_queue=8, deadline_s=30.0)
    g.acquire("a")
    g.acquire("a")  # at cap; 6 global slots still free
    granted_at = {}

    def waiter():
        g.acquire("a")
        granted_at["t"] = time.monotonic()
        g.release("a")

    t = threading.Thread(target=waiter)
    t.start()
    deadline = time.monotonic() + 2.0
    while g.snapshot()["waiting"] < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    t0 = time.monotonic()
    g.release("a")  # frees cap room: the waiter must wake now
    t.join(timeout=5)
    g.release("a")
    return "t" in granted_at and granted_at["t"] - t0 < 1.0, g.snapshot()


def test_capped_client_grant_wakes_promptly():
    woke, snap = _both(_capped_wake)
    assert woke and snap["inflight"] == 0 and snap["queued_total"] == 1


def _zero_slots(pkg, monkeypatch):
    monkeypatch.setenv("MTPU_MAX_CONCURRENT_ENCODES", "0")
    a = PKG[pkg].adm.AdmissionConfig.from_env().slots
    monkeypatch.setenv("MTPU_MAX_CONCURRENT_ENCODES", "junk")
    return a, PKG[pkg].adm.AdmissionConfig.from_env().slots


def test_env_zero_slots_means_cpu_default(monkeypatch):
    cpu = max(1, os.cpu_count() or 1)
    assert _both(_zero_slots, monkeypatch) == (cpu, cpu)


def _evicted(pkg):
    g = _gov(pkg, slots=4, per_client_cap=2, max_queue=8, deadline_s=1.0)
    for i in range(50):
        with g.slot(f"ephemeral-{i}"):
            pass
    return g._budgets, g.snapshot()


def test_idle_client_budgets_evicted():
    """Per-client budgets do not accrete (STS mints a key a session)."""
    budgets, snap = _both(_evicted)
    assert budgets == {} and snap["admitted_total"] == 50


def _mirroring(pkg):
    p = PKG[pkg]
    reg = FakeRegistry()
    p.adm.set_metrics(reg)
    g = _gov(pkg, slots=1, per_client_cap=1, max_queue=0, deadline_s=0.05)
    with g.slot("a"):
        refused = _err(pkg, lambda: g.acquire("b"))
    g.note_coalesced()
    return refused, reg.counts, reg.gauges, g.snapshot()


def test_metrics_mirroring():
    refused, counts, gauges, snap = _both(_mirroring)
    assert refused == "ErrOperationTimedOut"
    assert counts[("admission_admitted_total", ())] == 1
    assert counts[("admission_rejected_total",
                   (("reason", "queue_full"),))] == 1
    assert counts[("admission_coalesced_bypass_total", ())] == 1
    assert gauges[("admission_inflight", ())] == 0
    assert snap["coalesced_bypass_total"] == 1
    assert admission.ADMISSION_DESCRIPTORS == \
        jax_admission.ADMISSION_DESCRIPTORS


# ---------------------------------------------------------------------------
# the port's own cases, each on both packages


def _seeded_script(pkg, seed):
    """A seeded run of acquires and releases with no queue (every acquire
    is granted or refused at once): the outcome and snapshot of each."""
    rng = np.random.default_rng(seed)
    g = _gov(pkg, slots=3, per_client_cap=2, max_queue=0, deadline_s=0.01)
    held: list[str] = []
    trace = []
    for _ in range(200):
        if held and rng.random() < 0.45:
            c = held.pop(int(rng.integers(len(held))))
            g.release(c)
            trace.append(("release", c))
        else:
            c = f"c{int(rng.integers(4))}"
            err = _err(pkg, lambda: g.acquire(c))
            if err is None:
                held.append(c)
            trace.append(("acquire", c, err))
        trace.append(g.snapshot())
    return trace


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_script_grants_and_refusals(seed):
    trace = _both(_seeded_script, seed)
    acquires = [t for t in trace if isinstance(t, tuple) and t[0] == "acquire"]
    refused = sum(1 for t in acquires if t[2])
    granted = len(acquires) - refused
    assert refused and granted
    last = trace[-1]
    assert last["rejected_queue_full"] == refused
    assert last["arrivals_total"] == refused + granted


def _stress(pkg):
    """16 threads, a shortened switch interval, tight deadlines: every
    arrival ends granted or refused, and the identity holds."""
    g = _gov(pkg, slots=2, per_client_cap=1, max_queue=6, deadline_s=0.003)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def worker(i):
        for j in range(40):
            c = f"c{(i + j) % 5}"
            try:
                g.acquire(c)
            except PKG[pkg].errors.ErrOperationTimedOut:
                continue
            g.release(c)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    s = g.snapshot()
    return (s["arrivals_total"], s["inflight"], s["waiting"],
            s["arrivals_total"] == s["admitted_total"]
            + s["rejected_queue_full"] + s["rejected_deadline"]
            - s["late_grant_returns"], g._budgets)


def test_conservation_under_contention():
    for pkg in (PORT, JAX):
        arrivals, inflight, waiting, conserved, budgets = _stress(pkg)
        assert (arrivals, inflight, waiting) == (16 * 40, 0, 0)
        assert conserved and budgets == {}


def _grant_probe(g, domain: str, grants: list) -> None:
    grant_to = g._grant_to

    def probe(client):
        grants.append((domain, client))
        grant_to(client)

    g._grant_to = probe


def _object_slots(pkg, root, monkeypatch, single_core: bool):
    p = PKG[pkg]
    monkeypatch.setattr(p.eo, "BLOCK_SIZE_V2", SMALL_BLOCK)
    if pkg == PORT:
        monkeypatch.setattr(fanout, "SINGLE_CORE", single_core)
    else:
        monkeypatch.setattr(jax_eo, "_SINGLE_CORE", single_core)
        from minio_tpu.object import multipart as jax_mp
        monkeypatch.setattr(jax_mp, "_SINGLE_CORE", single_core)
    grants: list = []
    eg = p.adm.reconfigure(_cfg(pkg, slots=2, per_client_cap=2, max_queue=4,
                                deadline_s=5.0))
    rg = p.adm.reconfigure_read(_cfg(pkg, slots=2, per_client_cap=2,
                                     max_queue=4, deadline_s=5.0))
    _grant_probe(eg, "put", grants)
    _grant_probe(rg, "get", grants)
    root = root / pkg
    if pkg == PORT:
        disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}",
                              device="cpu") for i in range(4)]
        sets = ErasureSets(disks, 4, default_parity=2, device="cpu")
    else:
        disks = [JaxLocalStorage(str(root / f"d{i}"), endpoint=f"d{i}")
                 for i in range(4)]
        sets = JaxErasureSets(disks, 4, default_parity=2)
    sets.init_format()
    sets.make_bucket(BUCKET)
    data = np.random.default_rng(5).bytes(2 * SMALL_BLOCK + 99)
    with p.adm.client_context("writer"):
        sets.put_object(BUCKET, "obj", io.BytesIO(data), len(data))
        uid = sets.new_multipart_upload(BUCKET, "mp")
        sets.put_object_part(BUCKET, "mp", uid, 1, io.BytesIO(data),
                             len(data))
    with p.adm.client_context("reader"):
        sink = io.BytesIO()
        sets.get_object(BUCKET, "obj", sink)
    return grants, sink.getvalue() == data, eg.snapshot(), rg.snapshot()


@pytest.mark.parametrize("single_core", [False, True])
def test_object_layer_takes_the_slots(tmp_path, monkeypatch, single_core):
    """put_object and put_object_part take an encode slot (the whole call
    on one core, the encode alone on more), get_object a decode slot, each
    charged to the caller's identity."""
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "1024")
    grants, exact, esnap, rsnap = _both(_object_slots, tmp_path, monkeypatch,
                                        single_core)
    assert grants == [("put", "writer"), ("put", "writer"),
                      ("get", "reader")]
    assert exact and esnap["admitted_total"] == 2 and esnap["inflight"] == 0
    assert rsnap["admitted_total"] == 1 and rsnap["inflight"] == 0


def _server(pkg, root):
    if pkg == PORT:
        disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}",
                              device="cpu") for i in range(4)]
        sets = ErasureSets(disks, 4, default_parity=2, device="cpu")
        sets.init_format()
        ol = ErasureServerPools([sets], device="cpu")
        return S3Server(ol, IAMSys(ACCESS, SECRET), BucketMetadataSys(ol),
                        device="cpu").start()
    disks = [JaxLocalStorage(str(root / f"d{i}"), endpoint=f"d{i}")
             for i in range(4)]
    sets = JaxErasureSets(disks, 4, default_parity=2)
    sets.init_format()
    ol = JaxPools([sets])
    return JaxS3Server(ol, JaxIAMSys(ACCESS, SECRET),
                       JaxBucketMetadataSys(ol)).start()


@pytest.fixture
def http_env(monkeypatch):
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "1024")
    monkeypatch.setattr(jax_eo, "BLOCK_SIZE_V2", SMALL_BLOCK)
    monkeypatch.setattr(erasure_objects, "BLOCK_SIZE_V2", SMALL_BLOCK)


def _error_code(body: bytes) -> str:
    start = body.find(b"<Code>")
    return body[start + 6:body.find(b"</Code>")].decode() if start >= 0 \
        else ""


def _over_http(pkg, root, monkeypatch):
    """One server of `pkg`: the identity a GET's decode slot is charged
    to (tenant mode on, so the bucket shows), a GET refused while the
    read governor is saturated, and the PUTs past a full encode queue."""
    p = PKG[pkg]
    srv = _server(pkg, root / pkg)
    out = {}
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)
        assert c.request("PUT", f"/{BUCKET}")[0] == 200
        data = np.random.default_rng(9).bytes(3 * SMALL_BLOCK + 5)
        key = f"/{BUCKET}/obj"
        assert c.request("PUT", key, body=data)[0] == 200
        # The decode slot runs inside the body stream, after the
        # dispatch: it must still be charged to the caller.
        grants: list = []
        rg = p.adm.reconfigure_read(_cfg(pkg, slots=2, per_client_cap=2,
                                         max_queue=2, deadline_s=5.0))
        _grant_probe(rg, "get", grants)
        monkeypatch.setenv("MTPU_ADMISSION_TENANT", "bucket")
        status, _, body = c.request("GET", key)
        monkeypatch.delenv("MTPU_ADMISSION_TENANT")
        out["get"] = (status, body == data, grants)
        # Saturated: refused with a whole 503 document, no severed stream.
        rg = p.adm.reconfigure_read(_cfg(pkg, slots=1, per_client_cap=1,
                                         max_queue=0, deadline_s=5.0))
        rg.acquire("occupant")
        try:
            status, h, body = c.request("GET", key)
        finally:
            rg.release("occupant")
        out["saturated"] = (status, _error_code(body),
                            h.get("Content-Length") == str(len(body)))
        out["after"] = c.request("GET", key)[0]
        # A full encode queue: the PUT is refused at once, nothing stored.
        eg = p.adm.reconfigure(_cfg(pkg, slots=1, per_client_cap=1,
                                    max_queue=0, deadline_s=5.0))
        eg.acquire("occupant")
        try:
            t0 = time.monotonic()
            status, _, body = c.request("PUT", f"/{BUCKET}/refused",
                                        body=data)
            fast = time.monotonic() - t0 < 2.0
        finally:
            eg.release("occupant")
        out["full_put"] = (status, _error_code(body), fast,
                           c.request("HEAD", f"/{BUCKET}/refused")[0])
        out["snapshots"] = (eg.snapshot(), rg.snapshot())
    finally:
        srv.stop()
    return out


def test_admission_over_http(tmp_path, monkeypatch, http_env):
    """Both S3 servers over HTTP: the GET's decode slot charged to the
    caller's (key, bucket) through the body stream; 503 SlowDown before
    the status line while the read governor is saturated; 503 SlowDown for
    a PUT past a full encode queue, nothing stored."""
    out = _both(_over_http, tmp_path, monkeypatch)
    # In tenant mode the stream re-enters the caller's composed identity
    # under the request's bucket, which composes it once more: minio_tpu
    # does so too (ROADMAP Queue 3). It stays one identity a (key,
    # bucket), so fairness is unchanged.
    assert out["get"] == (200, True,
                          [("get", f"{ACCESS}\x1f{BUCKET}\x1f{BUCKET}")])
    assert out["saturated"] == (503, "SlowDown", True)
    assert out["after"] == 200
    assert out["full_put"] == (503, "SlowDown", True, 404)
    esnap, rsnap = out["snapshots"]
    assert esnap["rejected_queue_full"] == 1
    assert rsnap["rejected_queue_full"] == 0  # refused before acquire

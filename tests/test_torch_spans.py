"""The port's request spans (minio_tpu_torch/observability/spans.py)
against minio_tpu's, on the CPU.

Each case of tests/test_spans.py but its end-to-end one runs on both
packages (`pkg`): span nesting and parentage, the cross-thread carrier,
the MTPU_TRACE switch, fixed and automatic (running p99) thresholds, the
bounded exemplar store, the span_seconds histograms from the admission,
stage and fan-out sites, a trace hub hook (the port has no TraceHub, so
a stand-in subscriber takes the trees in both), the admin slow-requests
answer, the engine-stat deltas, and defer/resume with the byte-flow tag
and the admission identity.

Then one traced PUT and one degraded GET (drives 0, 5, 12 and 15 lost)
through each package's S3Server over 16 drives under the health wrapper,
with the serial and with the pipelined drivers: both packages must write
the same root, the same admission label and the same `stage` and
`quorum-wait` records by label and count (the records minio_tpu writes
whenever a trace is on; the `stage-wait`, `stage-stall`, hedge and
straggler records depend on timing and are not compared), and every
record of the port's trees, its disk and fan-out records included,
must hang in the request's tree. minio_tpu runs with
MTPU_WORKER_POOL=0, MTPU_CODEC=dense-gf8 and MTPU_ENCODE_ENGINE=device
(the port has the device engine alone), both at BLOCK_SIZE_V2 =
12 * 4096 so that the object of 10 blocks and a tail takes the
pipelined drivers' stage threads.
"""

import collections
import json
import shutil
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import minio_tpu.erasure.streaming as jax_streaming
import minio_tpu.object.erasure_objects as jax_eo
import minio_tpu.object.multipart as jax_mp
import minio_tpu.storage.diskcheck as jax_diskcheck
from minio_tpu.api import S3Server as JaxS3Server
from minio_tpu.api.admin import AdminHandlers as JaxAdminHandlers
from minio_tpu.bucket import BucketMetadataSys as JaxBucketMetadataSys
from minio_tpu.iam import IAMSys as JaxIAMSys
from minio_tpu.object import readtier as jax_readtier
from minio_tpu.object.pools import ErasureServerPools as JaxPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.observability import ioflow as jax_ioflow
from minio_tpu.observability import spans as jax_spans
from minio_tpu.observability.metrics import Metrics as JaxMetrics
from minio_tpu.pipeline import Pipeline as JaxPipeline
from minio_tpu.pipeline import Stage as JaxStage
from minio_tpu.pipeline import admission as jax_admission
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu.utils.fanout import quorum_wait as jax_quorum_wait
from minio_tpu_torch.api.admin import AdminHandlers
from minio_tpu_torch.api.client import S3Client
from minio_tpu_torch.api.server import S3Server
from minio_tpu_torch.bucket.metadata import BucketMetadataSys
from minio_tpu_torch.erasure import streaming
from minio_tpu_torch.iam.store import IAMSys
from minio_tpu_torch.object import erasure_objects
from minio_tpu_torch.object.pools import ErasureServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.observability import ioflow, spans
from minio_tpu_torch.observability.metrics import Metrics
from minio_tpu_torch.pipeline import Pipeline, Stage, admission
from minio_tpu_torch.storage.diskcheck import DiskHealth, MetricsDisk
from minio_tpu_torch.storage.local import LocalStorage
from minio_tpu_torch.utils import fanout
from minio_tpu_torch.utils.fanout import quorum_wait

torch.set_num_threads(1)

PORT, JAX = "port", "jax"
PKGS = {
    PORT: types.SimpleNamespace(
        spans=spans, ioflow=ioflow, admission=admission, Metrics=Metrics,
        Pipeline=Pipeline, Stage=Stage, quorum_wait=quorum_wait,
        streaming=streaming,
        admin=lambda: AdminHandlers(None, None, lambda: 0)),
    JAX: types.SimpleNamespace(
        spans=jax_spans, ioflow=jax_ioflow, admission=jax_admission,
        Metrics=JaxMetrics, Pipeline=JaxPipeline, Stage=JaxStage,
        quorum_wait=jax_quorum_wait, streaming=jax_streaming,
        admin=lambda: JaxAdminHandlers(None, None)),
}

ACCESS, SECRET = "tpuadmin", "tpuadmin-secret-key"
DEPLOYMENT = "5ba52d31-4f2e-4d69-92f5-926a51824ed9"
BLOCK = 12 * 4096
SIZE = 10 * BLOCK + 12_345
LOST = (0, 5, 12, 15)


def _reset_both():
    """Both packages' span planes, byte-flow ledgers and minio_tpu's read
    tier (which a hot bucket in its ledger arms) back to their start, so
    no case leaks into a later one in the same process."""
    for p in PKGS.values():
        p.spans.reset()
        p.spans.set_metrics(None)
        p.spans.set_trace_hub(None)
        p.ioflow.reset()
    jax_readtier.reset()


@pytest.fixture(autouse=True)
def _clean_spans(monkeypatch):
    monkeypatch.setenv("MTPU_TRACE_SLOW_MS", "0")
    monkeypatch.delenv("MTPU_TRACE", raising=False)
    _reset_both()
    yield
    _reset_both()


@pytest.fixture(params=[JAX, PORT])
def pkg(request):
    return PKGS[request.param]


def _assert_connected(tree):
    """One request root, and every record's parent in the tree."""
    ids = {s["id"] for s in tree["spans"]}
    roots = [s for s in tree["spans"] if s["parent"] == 0]
    assert [r["kind"] for r in roots] == ["request"], roots
    for s in tree["spans"]:
        assert s["parent"] == 0 or s["parent"] in ids, s


def test_span_nesting_parentage_and_capture(pkg):
    sp = pkg.spans
    with sp.request_trace("put_object", request_id="r1") as ctx:
        assert ctx is not None
        with sp.span("admission", "put"):
            pass
        with sp.span("worker", "encode"):
            sp.record("worker-exec", "encode pid 7", 1_000_000)
        sp.record("stage", "put/encode", 2_000_000)
    trees = sp.slow_requests()
    assert len(trees) == 1
    tree = trees[0]
    assert tree["api"] == "put_object"
    assert tree["request_id"] == "r1"
    _assert_connected(tree)
    by_kind = {s["kind"]: s for s in tree["spans"]}
    assert by_kind["worker-exec"]["parent"] == by_kind["worker"]["id"]
    assert by_kind["worker-exec"]["duration_us"] == 1000
    root = by_kind["request"]["id"]
    assert by_kind["admission"]["parent"] == root
    assert by_kind["stage"]["parent"] == root


def test_cross_thread_carrier_attributes_to_the_request(pkg):
    sp = pkg.spans
    seen = {}

    def stage_thread(carrier):
        with sp.activate(carrier):
            sp.record("stage", "pipe/encode", 5_000_000)
            seen["ctx"] = sp.current()

    with sp.request_trace("put_object") as ctx:
        t = threading.Thread(target=stage_thread, args=(sp.capture(),))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert seen["ctx"] is ctx
    kinds = [s["kind"] for s in sp.slow_requests()[-1]["spans"]]
    assert "stage" in kinds, kinds


def test_disabled_by_env(pkg, monkeypatch):
    monkeypatch.setenv("MTPU_TRACE", "0")
    sp = pkg.spans
    with sp.request_trace("put_object") as ctx:
        assert ctx is None
        assert sp.current() is None
        sp.record("stage", "x", 1)  # a no-op
    assert sp.slow_requests() == []


def test_fixed_threshold_filters_fast_requests(pkg, monkeypatch):
    monkeypatch.setenv("MTPU_TRACE_SLOW_MS", "10000")
    with pkg.spans.request_trace("get_object"):
        pass
    assert pkg.spans.slow_requests() == []


def test_auto_threshold_tracks_running_p99(pkg, monkeypatch):
    monkeypatch.setenv("MTPU_TRACE_SLOW_MS", "auto")
    sp = pkg.spans
    assert sp.slow_threshold_ms() == float("inf")
    for _ in range(sp.P99_RECALC_EVERY * 2):
        with sp.request_trace("head_object"):
            pass
    assert sp.slow_threshold_ms() != float("inf")


def test_slow_store_is_bounded(pkg):
    sp = pkg.spans
    for i in range(sp.SLOW_STORE_CAP + 10):
        with sp.request_trace(f"req{i}"):
            pass
    assert len(sp.slow_requests()) == sp.SLOW_STORE_CAP
    assert sp.clear_slow_requests() == sp.SLOW_STORE_CAP
    assert sp.slow_requests() == []


def test_caps_are_minio_tpus():
    for name in ("RING_RECORDS", "SLOW_STORE_CAP", "P99_WINDOW",
                 "P99_RECALC_EVERY", "MAX_TREE_SPANS", "MIN_AUTO_SAMPLES"):
        assert getattr(spans, name) == getattr(jax_spans, name), name
    assert spans.SPAN_DESCRIPTORS == jax_spans.SPAN_DESCRIPTORS


def test_exposition_has_span_kind_histograms(pkg):
    """span_seconds{kind=...} for the admission, stage, fan-out and
    request kinds after traffic through the instrumented sites."""
    reg = pkg.Metrics()
    pkg.spans.set_metrics(reg)
    gov = pkg.admission.AdmissionGovernor(
        pkg.admission.AdmissionConfig(slots=2))
    with pkg.spans.request_trace("put_object"):
        with gov.slot("client-a"):
            pkg.Pipeline("span-test", [
                pkg.Stage("double", lambda x: x * 2)]).run(range(3))
        pkg.quorum_wait(threading.Condition(), set(), lambda: 0, 0, 0.01,
                        0.0)
    text = reg.render_prometheus()
    for kind in ("admission", "stage", "fanout", "request"):
        assert f'mtpu_span_seconds_count{{kind="{kind}"}}' in text, kind
    assert reg.counter_value("trace_slow_captures_total") >= 1


class _Hub:
    """A trace hub stand-in: span trees for span subscribers only."""

    def __init__(self):
        self.any_spans = True
        self.trees = []

    def publish_spans(self, entry):
        self.trees.append(entry)


def test_trace_hub_routes_span_trees(pkg):
    hub = _Hub()
    pkg.spans.set_trace_hub(hub)
    with pkg.spans.request_trace("get_object"):
        pass
    entry = hub.trees[-1]
    assert entry["type"] == "spans"
    assert entry["api"] == "get_object"
    assert any(s["kind"] == "request" for s in entry["spans"])
    hub.any_spans = False
    hub.trees.clear()
    with pkg.spans.request_trace("get_object"):
        pass
    assert hub.trees == []


def test_admin_slow_requests_endpoint_shape(pkg):
    with pkg.spans.request_trace("put_object"):
        pkg.spans.record("stage", "put/encode", 123_000)
    admin = pkg.admin()

    class Ctx:
        qdict = {"n": "10"}

    body = json.loads(admin.slow_requests(Ctx()).body)
    assert body["threshold_ms"] == 0.0
    assert body["captured"][-1]["api"] == "put_object"
    assert json.loads(admin.slow_requests_clear(Ctx()).body)["cleared"] >= 1
    assert pkg.spans.slow_requests() == []


def test_engine_stats_deltas_ride_on_trees(pkg):
    with pkg.spans.request_trace("get_object"):
        pkg.streaming.record_stat("hedged_reads_total", 2)
    assert pkg.spans.slow_requests()[-1]["stats"]["hedged_reads"] == 2


def test_defer_resume_reenters_ioflow_tag_and_admission_identity(pkg):
    """The body of a streamed GET runs on the writer's thread after the
    handler's scope exited: resume() re-enters the op tag and the
    admission identity that defer() captured, scoped to the stream."""
    sp, io, adm = pkg.spans, pkg.ioflow, pkg.admission
    io.reset()
    try:
        rt = sp.request_trace("get_object")
        with adm.client_context("alice", bucket="hotb"):
            with io.tag("get", bucket="hotb"):
                with rt:
                    rt.defer()
        assert adm.identity() == ("", "")
        out = {}

        def stream():
            with sp.resume(rt):
                io.account("d0", "read", 1234)
                out["ident"] = adm.identity()
            out["after"] = adm.identity()

        t = threading.Thread(target=stream)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        b = io.snapshot()["bytes"]
        assert b.get(("d0", "get", "read")) == 1234
        assert ("d0", "untagged", "read") not in b
        assert out["ident"] == ("alice", "hotb")
        assert out["after"] == ("", "")
        assert rt.deferred is False
    finally:
        io.reset()


def test_defer_cancelled_by_handler_exception(pkg):
    rt = pkg.spans.request_trace("get_object")
    with pytest.raises(RuntimeError):
        with rt:
            rt.defer()
            raise RuntimeError("framing error before the stream")
    assert rt.deferred is False
    with pkg.spans.resume(rt) as ctx:
        assert ctx is None


# --- a traced PUT and degraded GET through both S3 servers -------------

def _server(pkg: str, root: Path):
    if pkg == PORT:
        disks = [MetricsDisk(LocalStorage(str(root / f"d{i}"),
                                          endpoint=f"d{i}", device="cpu"),
                             None, health=DiskHealth(f"d{i}"))
                 for i in range(16)]
        sets = ErasureSets(disks, 16, deployment_id=DEPLOYMENT,
                           default_parity=4, device="cpu")
        sets.init_format()
        ol = ErasureServerPools([sets], device="cpu")
        return S3Server(ol, IAMSys(ACCESS, SECRET), BucketMetadataSys(ol),
                        device="cpu").start()
    disks = [jax_diskcheck.MetricsDisk(
        JaxLocalStorage(str(root / f"d{i}"), endpoint=f"d{i}"), None,
        health=jax_diskcheck.DiskHealth(f"d{i}")) for i in range(16)]
    sets = JaxErasureSets(disks, 16, deployment_id=DEPLOYMENT,
                          default_parity=4)
    sets.init_format()
    ol = JaxPools([sets])
    return JaxS3Server(ol, JaxIAMSys(ACCESS, SECRET),
                       JaxBucketMetadataSys(ol)).start()


def _wait_trees(sp, apis, timeout_s: float = 30.0) -> dict:
    """The captured trees by API, once all of `apis` are in: a streamed
    GET finishes its trace after the client has its last byte."""
    deadline = time.monotonic() + timeout_s
    while True:
        trees = {t["api"]: t for t in sp.slow_requests()}
        if all(a in trees for a in apis) or time.monotonic() > deadline:
            return trees
        time.sleep(0.01)


def _traced_put_and_degraded_get(pkg: str, root: Path) -> dict:
    sp = PKGS[pkg].spans
    payload = np.random.default_rng(14).bytes(SIZE)
    srv = _server(pkg, root)
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)
        assert c.request("PUT", "/bkt")[0] == 200
        sp.clear_slow_requests()
        assert c.request("PUT", "/bkt/obj", body=payload)[0] == 200
        for i in LOST:
            shutil.rmtree(root / f"d{i}" / "bkt" / "obj")
        status, _, body = c.request("GET", "/bkt/obj")
        assert status == 200 and body == payload
        return _wait_trees(sp, ("put_object", "get_object"))
    finally:
        srv.stop()


def _deterministic(tree) -> collections.Counter:
    return collections.Counter(
        (s["kind"], s["label"]) for s in tree["spans"]
        if s["kind"] in ("request", "admission", "stage")
        or (s["kind"] == "fanout" and s["label"] == "quorum-wait"))


@pytest.mark.parametrize("single_core", [True, False],
                         ids=["serial", "pipelined"])
def test_traced_put_and_degraded_get_trees(tmp_path, monkeypatch,
                                           single_core):
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_ENCODE_ENGINE", "device")
    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "1024")
    monkeypatch.setattr(erasure_objects, "BLOCK_SIZE_V2", BLOCK)
    monkeypatch.setattr(jax_eo, "BLOCK_SIZE_V2", BLOCK)
    monkeypatch.setattr(fanout, "SINGLE_CORE", single_core)
    for mod in (jax_streaming, jax_eo, jax_mp, jax_diskcheck):
        monkeypatch.setattr(mod, "_SINGLE_CORE", single_core)
    trees = {pkg: _traced_put_and_degraded_get(pkg, tmp_path / pkg)
             for pkg in (JAX, PORT)}
    for api, admitted in (("put_object", "put"), ("get_object", "get")):
        want, got = trees[JAX][api], trees[PORT][api]
        assert _deterministic(got) == _deterministic(want), api
        labels = [s["label"] for s in got["spans"]
                  if s["kind"] == "admission"]
        assert labels == [admitted], labels
        _assert_connected(got)
        kinds = collections.Counter(s["kind"] for s in got["spans"])
        # The disk records of the drives' ops and the fan-out records of
        # the writer and reader hang in the request's tree, whichever
        # thread (stage, fan-out, per-drive pool) wrote them.
        assert kinds["disk"] > 0 and kinds["fanout"] > 0, kinds
        assert len(got["spans"]) < spans.MAX_TREE_SPANS
    if not single_core:
        assert _deterministic(trees[PORT]["put_object"])[
            ("stage", "put/dispatch")] > 0

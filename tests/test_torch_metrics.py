"""The port's metrics plane (observability/metrics.py, metrics_v2.py), its
health probes and its scrape and admin routes against minio_tpu's, on
the CPU.

- The descriptor catalog equals minio_tpu's less the four lists of the
  subsystems the port does not have (the worker pool, the mesh plane,
  the RPC plane, the read tier).
- The registry renders the same exposition after the same calls.
- Both packages' S3Servers, each with a registry, take the same signed
  request sequence (PUTs, GETs, a 404, an anonymous GET, a bad
  signature, an unknown key): the request, response, error, rx/tx and
  auth-failure counters agree series for series, and the latency
  histograms carry the same label sets.
- /minio/health/{live,ready,cluster} answer alike in every drive state
  of phase 4m's steps 3 and 6 (all up; the object lost on drives 0, 5,
  12 and 15; those drives offline; a fifth drive offline too, below
  quorum; the fifth back; all back), and for a POST and an unknown
  probe.
- The three scrape routes want SigV4 and admin:Prometheus in both; the
  admin ioflow, metrics and slow-requests answers have minio_tpu's
  shape.
- The port's Server installs its registry everywhere minio_tpu's does:
  a scrape after traffic holds the request, disk, admission, pipeline,
  codec, span, ledger, MRF-scoreboard and node series, and nothing
  outside the catalog.

minio_tpu runs with MTPU_WORKER_POOL=0 and MTPU_CODEC=dense-gf8, both at
BLOCK_SIZE_V2 = 12 * 1024 with MTPU_INLINE_THRESHOLD = 1024.
"""

import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import minio_tpu.object.erasure_objects as jax_eo
import minio_tpu.observability.metrics_v2 as jax_metrics_v2
from minio_tpu.api import S3Server as JaxS3Server
from minio_tpu.bucket import BucketMetadataSys as JaxBucketMetadataSys
from minio_tpu.distributed.rest import RPC_DESCRIPTORS
from minio_tpu.iam import IAMSys as JaxIAMSys
from minio_tpu.object.pools import ErasureServerPools as JaxPools
from minio_tpu.object import readtier as jax_readtier
from minio_tpu.object.readtier import READTIER_DESCRIPTORS
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.observability import ioflow as jax_ioflow
from minio_tpu.observability import spans as jax_spans
from minio_tpu.observability.metrics import Metrics as JaxMetrics
from minio_tpu.parallel.metrics import MESH_DESCRIPTORS
from minio_tpu.pipeline.workers import WORKER_DESCRIPTORS
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu_torch.api.client import S3Client
from minio_tpu_torch.api.server import S3Server
from minio_tpu_torch.bucket.metadata import BucketMetadataSys
from minio_tpu_torch.iam.store import IAMSys
from minio_tpu_torch.object import erasure_objects
from minio_tpu_torch.object.pools import ErasureServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.observability import ioflow, metrics_v2, spans
from minio_tpu_torch.observability.metrics import Metrics
from minio_tpu_torch.server import Server, _install_metrics
from minio_tpu_torch.storage.local import LocalStorage

torch.set_num_threads(1)

PORT, JAX = "port", "jax"
ACCESS, SECRET = "tpuadmin", "tpuadmin-secret-key"
DEPLOYMENT = "5ba52d31-4f2e-4d69-92f5-926a51824ed9"
BLOCK = 12 * 1024
LOST = (0, 5, 12, 15)
SCRAPES = ("/minio/v2/metrics/cluster", "/minio/v2/metrics/node",
           "/minio/prometheus/metrics")
REQUEST_SERIES = ("s3_requests_total", "s3_responses_total",
                  "s3_errors_total", "s3_rx_bytes_total",
                  "s3_tx_bytes_total", "s3_auth_failures_total")
_LINE = re.compile(r"^(mtpu_[a-z0-9_]+)(\{[^}]*\})? (\S+)$")


@pytest.fixture(autouse=True)
def _planes_restored():
    """Both byte-flow ledgers and span stores, and minio_tpu's read tier
    (which a hot bucket in its ledger arms), back to their start after
    each case, so none leaks into a later one in the same process."""
    yield
    for io_ in (ioflow, jax_ioflow):
        io_.reset()
    for sp in (spans, jax_spans):
        sp.reset()
    jax_readtier.reset()


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "1024")
    monkeypatch.setenv("MTPU_TRACE_SLOW_MS", "0")
    monkeypatch.setattr(erasure_objects, "BLOCK_SIZE_V2", BLOCK)
    monkeypatch.setattr(jax_eo, "BLOCK_SIZE_V2", BLOCK)


def _series(text: str) -> dict:
    """{(name, labels): value} of a Prometheus exposition."""
    out = {}
    for line in text.splitlines():
        m = _LINE.match(line)
        if m:
            out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


def _server(pkg: str, root: Path):
    """A 12+4 S3Server on 16 drives of `pkg` with its own registry, and
    its raw drives."""
    if pkg == PORT:
        disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}",
                              device="cpu") for i in range(16)]
        sets = ErasureSets(disks, 16, deployment_id=DEPLOYMENT,
                           default_parity=4, device="cpu")
        sets.init_format()
        ol = ErasureServerPools([sets], device="cpu")
        srv = S3Server(ol, IAMSys(ACCESS, SECRET), BucketMetadataSys(ol),
                       device="cpu", metrics=Metrics())
    else:
        disks = [JaxLocalStorage(str(root / f"d{i}"), endpoint=f"d{i}")
                 for i in range(16)]
        sets = JaxErasureSets(disks, 16, deployment_id=DEPLOYMENT,
                              default_parity=4)
        sets.init_format()
        ol = JaxPools([sets])
        srv = JaxS3Server(ol, JaxIAMSys(ACCESS, SECRET),
                          JaxBucketMetadataSys(ol), metrics=JaxMetrics())
    return srv.start(), disks


@pytest.fixture
def servers(small, tmp_path):
    out = {pkg: _server(pkg, tmp_path / pkg) for pkg in (JAX, PORT)}
    yield out
    for srv, _ in out.values():
        srv.stop()


def _clients(servers) -> dict:
    return {pkg: S3Client(srv.endpoint, ACCESS, SECRET)
            for pkg, (srv, _) in servers.items()}


# --- the catalog and the registry ------------------------------------------

def test_catalog_is_minio_tpus_less_four_lists():
    excluded = (set(WORKER_DESCRIPTORS) | set(MESH_DESCRIPTORS)
                | set(RPC_DESCRIPTORS) | set(READTIER_DESCRIPTORS))
    want = [d for d in jax_metrics_v2.DESCRIPTORS if d not in excluded]
    assert metrics_v2.DESCRIPTORS == want
    assert len({name for name, _, _ in want}) == len(want)


def _counters(m):
    m.inc("s3_requests_total", api="get_object")
    m.inc("s3_requests_total", 2, api="put_object")
    m.set_counter("ioflow_bytes_total", 77, drive="d1", op="put",
                  dir="write")


def _gauges(m):
    m.inc_gauge("s3_requests_inflight")
    m.inc_gauge("s3_requests_inflight", -1)
    m.set_gauge("disk_online", 1.0, disk="d3")
    m.replace_gauge_series("bucket_usage_total_bytes",
                           [({"bucket": "a"}, 5), ({"bucket": "b"}, 7)])


def _histograms(m):
    for v in (0.0005, 0.003, 0.2, 7.5, 30.0):
        m.observe("span_seconds", v, kind="stage")
    m.observe("disk_op_seconds", 0.01, op="read_version")


def _described(m):
    metrics_v2.describe_all(m)
    m.inc("heal_objects_total", trigger="mrf")
    m.replace_counter_series("hot_bucket_bytes_total",
                             [({"bucket": "hot"}, 4096)])


@pytest.mark.parametrize("calls", [_counters, _gauges, _histograms,
                                   _described])
def test_registry_renders_like_minio_tpus(calls):
    port, jax = Metrics(), JaxMetrics()
    calls(port)
    calls(jax)
    if calls is _described:
        for name, _, help_text in metrics_v2.DESCRIPTORS:
            jax.describe(name, help_text)

    def body(m):
        return [ln for ln in m.render_prometheus().splitlines()
                if "uptime_seconds" not in ln]

    assert body(port) == body(jax)
    assert port.counter_value("s3_requests_total", api="put_object") == (
        jax.counter_value("s3_requests_total", api="put_object"))


# --- request series over HTTP ----------------------------------------------

def _sequence(c: S3Client) -> list:
    payload = np.random.default_rng(3).bytes(30_001)
    statuses = [
        c.request("PUT", "/bkt")[0],
        c.request("PUT", "/bkt/obj", body=payload)[0],
        c.request("PUT", "/bkt/small", body=b"x" * 700)[0],
        c.request("GET", "/bkt/obj")[0],
        c.request("HEAD", "/bkt/obj")[0],
        c.request("GET", "/bkt/nope")[0],
        c.request("GET", "/bkt/obj", anonymous=True)[0],
        S3Client(c.endpoint, ACCESS, "wrong-secret-key").request(
            "GET", "/bkt/obj")[0],
        S3Client(c.endpoint, "nobody", SECRET).request(
            "GET", "/bkt/small")[0],
        c.request("GET", "/bkt", [("list-type", "2")])[0],
        c.request("DELETE", "/bkt/small")[0],
        c.request("GET", "/minio/health/live")[0],
    ]
    return statuses


def test_request_series_agree_over_http(servers):
    clients = _clients(servers)
    statuses = {pkg: _sequence(c) for pkg, c in clients.items()}
    assert statuses[PORT] == statuses[JAX]
    got = {}
    for pkg, (srv, _) in servers.items():
        series = _series(srv.metrics.render_prometheus())
        got[pkg] = {k: v for k, v in series.items()
                    if k[0][len("mtpu_"):] in REQUEST_SERIES}
        got[pkg]["labels"] = sorted(
            k[1] for k in series if k[0] == "mtpu_s3_request_seconds_count")
    assert got[PORT] == got[JAX]
    assert got[PORT][("mtpu_s3_auth_failures_total",
                      '{code="AccessDenied"}')] == 1


# --- health probes ---------------------------------------------------------

def _probes(c: S3Client) -> dict:
    out = {kind: c.request("GET", f"/minio/health/{kind}", anonymous=True)[0]
           for kind in ("live", "ready", "cluster")}
    out["head_ready"] = c.request("HEAD", "/minio/health/ready",
                                  anonymous=True)[0]
    out["post_live"] = c.request("POST", "/minio/health/live",
                                 anonymous=True)[0]
    out["unknown"] = c.request("GET", "/minio/health/other",
                               anonymous=True)[0]
    return out


def test_health_codes_agree_in_every_drive_state(servers, tmp_path):
    clients = _clients(servers)
    for c in clients.values():
        assert c.request("PUT", "/bkt")[0] == 200
        assert c.request("PUT", "/bkt/obj", body=b"y" * 40_001)[0] == 200
    states = {}

    def probe(state):
        states[state] = {pkg: _probes(c) for pkg, c in clients.items()}

    def online(drives, up: bool):
        for _, disks in servers.values():
            for i in drives:
                disks[i].set_online(up)

    probe("all_up")
    for pkg in clients:
        for i in LOST:
            shutil.rmtree(tmp_path / pkg / f"d{i}" / "bkt" / "obj")
    probe("object_lost")
    online(LOST, False)
    probe("four_away")
    online((1,), False)
    probe("fifth_away")
    online((1,), True)
    probe("fifth_back")
    online(LOST, True)
    probe("all_back")
    for state, codes in states.items():
        assert codes[PORT] == codes[JAX], state
    up = {"live": 200, "ready": 200, "cluster": 200, "head_ready": 200,
          "post_live": 405, "unknown": 404}
    for state in ("all_up", "object_lost", "four_away", "fifth_back",
                  "all_back"):
        assert states[state][PORT] == up, state
    assert states["fifth_away"][PORT] == dict(
        up, ready=503, cluster=503, head_ready=503)


# --- scrape and admin routes -----------------------------------------------

@pytest.mark.parametrize("path", SCRAPES)
def test_scrape_wants_sigv4_and_prometheus_action(servers, path):
    for pkg, c in _clients(servers).items():
        anon = c.request("GET", path, anonymous=True)
        assert anon[0] == 403, (pkg, anon[0])
        status, headers, body = c.request("GET", path)
        assert status == 200, pkg
        assert headers["Content-Type"].startswith("text/plain")
        assert c.request("PUT", path)[0] == 405, pkg


def _shape(obj):
    """The keys of a JSON answer, nested, with list items' shapes."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(obj[0])] if obj else []
    return type(obj).__name__ if obj is not None else None


@pytest.mark.parametrize("route", ["ioflow", "slow-requests"])
def test_admin_answers_have_minio_tpus_shape(servers, route):
    shapes = {}
    for pkg, c in _clients(servers).items():
        assert c.request("PUT", "/bkt")[0] == 200
        assert c.request("PUT", "/bkt/obj", body=b"z" * 20_001)[0] == 200
        status, _, body = c.request("GET", f"/minio/admin/v3/{route}")
        assert status == 200, pkg
        ans = json.loads(body)
        if route == "slow-requests":
            ans["captured"] = ans["captured"][-1:]
            ans["captured"][0]["spans"] = ans["captured"][0]["spans"][:1]
            # The engine counters each package keeps.
            ans["captured"][0].pop("stats")
        shapes[pkg] = _shape(ans)
    assert shapes[PORT] == shapes[JAX]


def test_admin_metrics_route_is_the_exposition(servers):
    for pkg, c in _clients(servers).items():
        status, headers, body = c.request("GET", "/minio/admin/v3/metrics")
        assert status == 200, pkg
        assert headers["Content-Type"] == "text/plain; version=0.0.4"
        assert b"# TYPE mtpu_s3_requests_inflight gauge" in body
        assert c.request("DELETE", "/minio/admin/v3/slow-requests")[0] == 200


def test_rest_of_minio_namespace_not_implemented(servers):
    c = _clients(servers)[PORT]
    for path in ("/minio/console/", "/minio/v2/metrics/bucket",
                 "/crossdomain.xml"):
        status, _, body = c.request("GET", path)
        assert status == 501 and b"NotImplemented" in body, path


# --- the port's Server wires the registry ----------------------------------

def _family(name: str) -> str:
    """The catalog name of an exposed series."""
    name = name[len("mtpu_"):]
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix) and name[: -len(suffix)] in _HISTOGRAMS:
            return name[: -len(suffix)]
    return name


_HISTOGRAMS = {n for n, t, _ in metrics_v2.DESCRIPTORS if t == "histogram"}


@pytest.fixture
def hooks_restored():
    yield
    _install_metrics(None)
    spans.set_metrics(None)
    jax_spans.set_metrics(None)


def test_server_scrape_holds_only_catalog_series(small, tmp_path,
                                                 hooks_restored):
    server = Server([str(tmp_path / "d{1...16}")], port=0,
                    root_user=ACCESS, root_password=SECRET,
                    default_parity=4, device="cpu")
    server.s3.start()
    try:
        c = S3Client(server.endpoint, ACCESS, SECRET)
        assert c.request("PUT", "/bkt")[0] == 200
        payload = np.random.default_rng(4).bytes(10 * BLOCK + 17)
        assert c.request("PUT", "/bkt/obj", body=payload)[0] == 200
        assert c.request("GET", "/bkt/obj")[2] == payload
        status, _, body = c.request("GET", "/minio/v2/metrics/node")
        assert status == 200
    finally:
        server.stop()
    families = {_family(name) for name, _ in _series(body.decode())}
    catalog = {n for n, _, _ in metrics_v2.DESCRIPTORS} | {"uptime_seconds"}
    assert families <= catalog, families - catalog
    for want in ("s3_requests_total", "s3_request_seconds",
                 "disk_ops_total", "disk_op_seconds", "disk_online",
                 "admission_admitted_total", "pipeline_runs_total",
                 "mtpu_codec_dispatch_total", "mtpu_codec_selected_total",
                 "span_seconds", "trace_slow_captures_total",
                 "ioflow_bytes_total", "ioflow_logical_bytes_total",
                 "erasure_set_health", "mrf_pending", "node_threads"):
        assert want in families, want


# --- the server's boot self-tests and pool start -------------------------

def test_aead_self_test_holds_the_known_answer(monkeypatch):
    from minio_tpu_torch import server as server_mod

    server_mod.aead_self_test("cpu")
    bad = bytearray(server_mod._GCM_SEALED)
    bad[-1] ^= 1
    monkeypatch.setattr(server_mod, "_GCM_SEALED", bytes(bad))
    with pytest.raises(RuntimeError, match="aead self-test"):
        server_mod.aead_self_test("cpu")


@pytest.mark.parametrize("single_core", [True, False],
                         ids=["serial", "pipelined"])
@pytest.mark.parametrize("k,m", [(12, 4), (4, 4)])
def test_streaming_self_test(monkeypatch, single_core, k, m):
    """The boot test of the encrypted PUT and degraded GET path, at small
    blocks on both drivers; a PUT that loses bytes stops it."""
    from minio_tpu_torch import server as server_mod
    from minio_tpu_torch.utils import fanout

    monkeypatch.setattr(fanout, "SINGLE_CORE", single_core)
    server_mod.streaming_self_test("cpu", k, m, k * 256)

    class Lossy(server_mod.StreamingBitrotWriter):
        def write_with_digest(self, chunk, digest):
            return super().write_with_digest(bytes(len(chunk)), digest)

    monkeypatch.setattr(server_mod, "StreamingBitrotWriter", Lossy)
    with pytest.raises(Exception):
        server_mod.streaming_self_test("cpu", k, m, k * 256)


def test_prestart_starts_the_pools_workers():
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from minio_tpu_torch.utils import fanout

    pool = ThreadPoolExecutor(max_workers=5)
    try:
        before = threading.active_count()
        fanout.prestart(pool, 9)  # at most the pool's ceiling
        assert threading.active_count() - before == 5
        fanout.prestart(pool, 3)  # idle workers serve it
        assert threading.active_count() - before == 5
    finally:
        pool.shutdown()


@pytest.mark.parametrize("extra,kept", [(0, True), (300 << 10, False)],
                         ids=["small_body_drained", "large_body_severed"])
def test_refused_body_is_drained_or_severed(servers, extra, kept):
    """A PUT refused before its body is read (no such bucket): a body of
    at most 256 KiB is read and dropped, so the answer arrives whole and
    the connection serves the next request; a larger one is severed."""
    import http.client

    from minio_tpu_torch.api import sign

    srv, _ = servers[PORT]
    body = b"q" * (70_000 + extra)
    conn = http.client.HTTPConnection(srv.endpoint, timeout=30)
    try:
        headers = sign.sign_v4_request(
            SECRET, ACCESS, "PUT", srv.endpoint, "/nobucket/obj",
            payload_hash=sign.UNSIGNED_PAYLOAD)
        conn.request("PUT", "/nobucket/obj", body=body, headers=headers)
        resp = conn.getresponse()
        assert resp.status == 404 and b"NoSuchBucket" in resp.read()
        assert (resp.getheader("Connection") != "close") == kept
        if kept:
            headers = sign.sign_v4_request(SECRET, ACCESS, "GET",
                                           srv.endpoint, "/")
            conn.request("GET", "/", headers=headers)
            assert conn.getresponse().status == 200
    finally:
        conn.close()

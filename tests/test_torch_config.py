"""The config subsystem of the port (minio_tpu_torch/config) against
minio_tpu's (minio_tpu/config), on the CPU.

- tests/test_config_history.py case for case, and from
  tests/test_admin_api.py test_config_kv_roundtrip,
  test_config_env_override and test_config_unknown_key_rejected; from
  tests/test_conformance.py test_requests_max_throttle.
- With os.urandom seeded and the clock made alike, the port's sealed
  blob, its history and a restore are minio_tpu's bytes, and each
  package unseals the other's.
- The six admin config routes over HTTP answer as minio_tpu's (the
  {"restart": ...} flag, help, del, the history with data, restore,
  NoSuchKey, InvalidArgument), with admin:ConfigUpdate required.
- The `drive` subsystem (env and stored) reaches the drives' health
  deadlines, the `heal` subsystem the admin heal's gate and pause, and
  `api cors_allow_origin` the CORS answers, as in minio_tpu.
"""

import json
import os
import random
import threading
import time as _time
import types

import pytest

from minio_tpu.api import S3Server as JaxS3Server
from minio_tpu.bucket import BucketMetadataSys as JaxBucketMetadataSys
from minio_tpu.config import config as jax_config_mod
from minio_tpu.config.config import Config as JaxConfig
from minio_tpu.config.config import ConfigSys as JaxConfigSys
from minio_tpu.iam import IAMSys as JaxIAMSys
from minio_tpu.object.pools import ErasureServerPools as JaxPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.server import Server as JaxServer
from minio_tpu.storage import diskcheck as jax_dc
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu.utils.errors import ErrObjectNotFound as JaxNotFound
from minio_tpu_torch.api.client import S3Client
from minio_tpu_torch.api.server import S3Server
from minio_tpu_torch.bucket.metadata import BucketMetadataSys
from minio_tpu_torch.config import config as config_mod
from minio_tpu_torch.config.config import Config, ConfigSys
from minio_tpu_torch.crypto.aead import InvalidTag
from minio_tpu_torch.iam.store import Credentials, IAMSys
from minio_tpu_torch.object.pools import ErasureServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.server import Server
from minio_tpu_torch.storage import diskcheck as dc
from minio_tpu_torch.storage.local import LocalStorage
from minio_tpu_torch.utils.errors import ErrObjectNotFound

PORT, JAX = "port", "jax"
PKGS = (JAX, PORT)
ACCESS, SECRET = "adminkey", "adminsecretkey"
DEPLOYMENT = "77777777-8888-9999-aaaa-bbbbbbbbbbbb"


class _MemLayer:
    """tests/test_config_history.py's object-layer stand-in."""

    def __init__(self, not_found):
        self.blobs: dict[str, bytes] = {}
        self._not_found = not_found

    def put_object(self, bucket, path, reader, size, opts=None):
        self.blobs[path] = reader.read()

    def get_object_bytes(self, bucket, path, opts=None):
        if path not in self.blobs:
            raise self._not_found(path)
        return self.blobs[path]

    def make_bucket(self, bucket, opts=None):
        pass

    def list_objects(self, bucket, prefix="", marker="", delimiter="",
                     max_keys=1000):
        names = [p for p in sorted(self.blobs) if p.startswith(prefix)]
        return types.SimpleNamespace(
            objects=[types.SimpleNamespace(name=n) for n in names])


def _config_sys(pkg, layer=None, secret="s"):
    if pkg == PORT:
        return ConfigSys(layer or _MemLayer(ErrObjectNotFound),
                         secret=secret, device="cpu")
    return JaxConfigSys(layer or _MemLayer(JaxNotFound), secret=secret)


# --- tests/test_config_history.py, case for case ------------------------

def test_sealed_blob_is_encrypted():
    sys_ = _config_sys(PORT, secret="root-secret")
    sys_.config.set_kv("region", name="eu-west-1")
    sys_.save()
    blob = sys_._ol.blobs["config/config.json"]
    assert blob.startswith(b"AESG\x00\x00")
    assert b"eu-west-1" not in blob
    thief = ConfigSys(sys_._ol, secret="wrong", device="cpu")
    with pytest.raises(InvalidTag):
        thief._unseal(blob)
    again = ConfigSys(sys_._ol, secret="root-secret", device="cpu")
    again.load()
    assert again.config.get("region")["name"] == "eu-west-1"


@pytest.mark.parametrize("pkg", PKGS)
def test_history_and_restore(pkg):
    sys_ = _config_sys(pkg)
    sys_.config.set_kv("region", name="v1-region")
    sys_.save()
    sys_.config.set_kv("region", name="v2-region")
    sys_.save()
    names = sorted(sys_.history())
    assert len(names) == 2
    sys_.restore(names[0])
    assert sys_.config.get("region")["name"] == "v1-region"
    assert len(sys_.history()) == 3


@pytest.mark.parametrize("pkg", PKGS)
def test_restore_rejects_traversal(pkg):
    with pytest.raises(ValueError):
        _config_sys(pkg).restore("../../../etc/passwd")


@pytest.mark.parametrize("pkg", PKGS)
def test_restore_validates_before_it_replaces(pkg):
    """An entry that fails today's validation is refused and the live
    config stays."""
    sys_ = _config_sys(pkg)
    raw = json.loads(sys_.config.to_json())
    raw["notify_redis"]["_"]["enable"] = "on"  # no address
    sys_._ol.blobs["config/history/bad.kv"] = sys_._seal(
        json.dumps(raw).encode())
    sys_.config.set_kv("region", name="live")
    with pytest.raises(ValueError):
        sys_.restore("bad.kv")
    assert sys_.config.get("region")["name"] == "live"


# --- tests/test_admin_api.py's config cases ------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_config_unknown_key_rejected(pkg):
    c = Config() if pkg == PORT else JaxConfig()
    with pytest.raises(ValueError):
        c.set_kv("scanner", nonsense="1")
    with pytest.raises(ValueError):
        c.set_kv("nosuch", delay="1")
    # reject and revert: an enabled target without its required key
    with pytest.raises(ValueError):
        c.set_kv("notify_webhook:x", enable="on")
    assert c.get("notify_webhook:x")["enable"] == "off"


@pytest.mark.parametrize("pkg", PKGS)
def test_config_env_override(pkg, monkeypatch):
    c = Config() if pkg == PORT else JaxConfig()
    c.set_kv("scanner", delay="20")
    monkeypatch.setenv("MTPU_SCANNER_DELAY", "99")
    assert c.get("scanner")["delay"] == "99"
    monkeypatch.setenv("MTPU_NOTIFY_WEBHOOK_ENDPOINT_PRIMARY", "http://x")
    assert c.get("notify_webhook:primary")["endpoint"] == "http://x"
    assert c.get("notify_webhook")["endpoint"] == ""


def test_subsystems_and_help_are_minio_tpus():
    assert config_mod.SUBSYSTEMS == jax_config_mod.SUBSYSTEMS
    assert config_mod.HELP == jax_config_mod.HELP
    assert len(config_mod.SUBSYSTEMS) == 20


class _Clock:
    """One clock for both packages' history names."""

    def __init__(self):
        self.ns = 1_700_000_000_123_456_789

    def time_ns(self):
        self.ns += 1_000_017
        return self.ns

    def gmtime(self, *a):
        return _time.gmtime(self.ns // 10 ** 9)

    def strftime(self, fmt, t):
        return _time.strftime(fmt, t)


def _seeded_history(pkg, mp) -> dict:
    clock = _Clock()
    shim = types.SimpleNamespace(time_ns=clock.time_ns, gmtime=clock.gmtime,
                                 strftime=clock.strftime)
    mp.setattr(config_mod if pkg == PORT else jax_config_mod, "time", shim)
    rng = random.Random(2024)
    mp.setattr(os, "urandom", rng.randbytes)
    sys_ = _config_sys(pkg, secret="root-secret")
    sys_.config.set_kv("compression", enable="on", extensions=".log")
    sys_.save()
    sys_.config.set_kv("storage_class", rrs="EC:2")
    sys_.config.set_kv("notify_webhook:primary", enable="on",
                       endpoint="http://hook")
    sys_.save()
    sys_.restore(sorted(sys_.history())[0])
    return dict(sys_._ol.blobs)


def test_seeded_blobs_and_history_equal_minio_tpus():
    runs = {}
    for pkg in PKGS:
        with pytest.MonkeyPatch.context() as mp:
            runs[pkg] = _seeded_history(pkg, mp)
    assert runs[PORT] == runs[JAX]
    assert len(runs[PORT]) == 4  # config.json and three history entries
    assert all(b.startswith(b"AESG\x00\x00") for b in runs[PORT].values())


@pytest.mark.parametrize("writer,reader", ((JAX, PORT), (PORT, JAX)))
def test_each_package_unseals_the_others(writer, reader):
    w = _config_sys(writer, secret="root-secret")
    w.config.set_kv("api", requests_max="7", cors_allow_origin="https://a")
    w.config.set_kv("drive", op_deadline="9s")
    w.save()
    layer = w._ol
    layer._not_found = ErrObjectNotFound if reader == PORT else JaxNotFound
    r = _config_sys(reader, layer=layer, secret="root-secret")
    r.load()
    assert r.config.get("api")["requests_max"] == "7"
    assert r.config.get("drive")["op_deadline"] == "9s"
    assert json.loads(r.history_get(r.history()[0])) == json.loads(
        w.config.to_json())
    plain = _config_sys(writer, secret="")
    plain.save()
    r2 = _config_sys(reader, layer=plain._ol, secret="")
    r2.load()
    assert plain._ol.blobs["config/config.json"].startswith(b"PLAIN\x00")
    assert r2.config.to_json() == plain.config.to_json()


# --- the admin config routes over HTTP ----------------------------------

def _s3server(pkg, root, config_sys_kv=None):
    """An S3Server over 4 fresh drives with a ConfigSys sealed under
    SECRET, set from `config_sys_kv` before the server is built."""
    if pkg == PORT:
        disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}",
                              device="cpu") for i in range(4)]
        sets = ErasureSets(disks, 4, deployment_id=DEPLOYMENT, device="cpu")
        sets.init_format()
        ol = ErasureServerPools([sets], device="cpu")
        cs = ConfigSys(ol, secret=SECRET)
    else:
        disks = [JaxLocalStorage(str(root / f"d{i}"), endpoint=f"d{i}")
                 for i in range(4)]
        sets = JaxErasureSets(disks, 4, deployment_id=DEPLOYMENT)
        sets.init_format()
        ol = JaxPools([sets])
        cs = JaxConfigSys(ol, secret=SECRET)
    for target, kv in (config_sys_kv or {}).items():
        cs.config.set_kv(target, **kv)
    if pkg == PORT:
        srv = S3Server(ol, IAMSys(ACCESS, SECRET), BucketMetadataSys(ol),
                       device="cpu", config_sys=cs)
    else:
        srv = JaxS3Server(ol, JaxIAMSys(ACCESS, SECRET),
                          JaxBucketMetadataSys(ol), config_sys=cs)
    return srv.start(), cs


@pytest.fixture(params=PKGS)
def stack(tmp_path, request):
    srv, cs = _s3server(request.param, tmp_path)
    yield S3Client(srv.endpoint, ACCESS, SECRET), cs, request.param
    srv.stop()


def test_config_kv_roundtrip(stack):
    c, config_sys, pkg = stack
    st, _, body = c.request("PUT", "/minio/admin/v3/set-config-kv",
                            body=b"scanner delay=20 max_wait=30s")
    assert st == 200 and json.loads(body) == {"restart": False}
    st, _, body = c.request("GET", "/minio/admin/v3/get-config-kv",
                            [("key", "scanner")])
    kvs = json.loads(body)["scanner"]
    assert kvs["delay"] == "20" and kvs["max_wait"] == "30s"
    reloaded = (ConfigSys if pkg == PORT else JaxConfigSys)(
        config_sys._ol, secret=SECRET)
    reloaded.load()
    assert reloaded.config.get("scanner")["delay"] == "20"
    assert reloaded.history()
    st, _, _ = c.request("GET", "/minio/admin/v3/get-config-kv",
                         [("key", "nosuchsubsys")])
    assert st == 400


def _config_answers(c) -> list:
    """One signed sequence over every config route."""
    seq = [("PUT", "set-config-kv", None, b"api requests_max=4"),
           ("PUT", "set-config-kv", None, b"api cors_allow_origin=*"),
           ("PUT", "set-config-kv", None, b"heal max_io=3"),
           ("PUT", "set-config-kv", None, b"notify_redis:q enable=on"),
           ("PUT", "set-config-kv", None, b"nosuch a=b"),
           ("PUT", "set-config-kv", None, b""),
           ("GET", "get-config-kv", [("key", "api")], b""),
           ("GET", "get-config-kv", [("key", "heal")], b""),
           ("GET", "get-config-kv", [], b""),
           ("DELETE", "del-config-kv", None, b"heal"),
           ("DELETE", "del-config-kv", None, b""),
           ("DELETE", "del-config-kv", None, b"nosuch"),
           ("GET", "get-config-kv", [("key", "heal")], b""),
           ("GET", "help-config-kv", [], b""),
           ("PUT", "restore-config-history-kv", [], b""),
           ("PUT", "restore-config-history-kv",
            [("restoreId", "2020-bogus.kv")], b""),
           ("PUT", "restore-config-history-kv",
            [("restoreId", "../x")], b"")]
    out = []
    for method, route, query, body in seq:
        st, _, raw = c.request(method, f"/minio/admin/v3/{route}", query,
                               body=body)
        out.append((st, json.loads(raw) if raw.startswith((b"{", b"["))
                    else None))
    st, _, raw = c.request("GET", "/minio/admin/v3/list-config-history-kv",
                           [("with-data", "true"), ("count", "2")])
    hist = json.loads(raw)
    out.append((st, [sorted(e) for e in hist], [e["kv"]["api"]
                                               for e in hist]))
    st, _, raw = c.request("PUT", "/minio/admin/v3/restore-config-history-kv",
                           [("restoreId", hist[-1]["restoreId"])])
    out.append((st, sorted(json.loads(raw))))
    st, _, raw = c.request("GET", "/minio/admin/v3/get-config-kv",
                           [("key", "api")])
    out.append((st, json.loads(raw)))
    return out


def test_config_routes_answer_as_minio_tpus(tmp_path):
    answers = {}
    for pkg in PKGS:
        srv, _ = _s3server(pkg, tmp_path / pkg)
        try:
            answers[pkg] = _config_answers(
                S3Client(srv.endpoint, ACCESS, SECRET))
        finally:
            srv.stop()
    assert answers[PORT] == answers[JAX]
    assert answers[PORT][0] == (200, {"restart": True})
    assert answers[PORT][2] == (200, {"restart": False})


class _Reader(IAMSys):
    """The root and a second key that may sign but holds no rights."""

    def get_credentials(self, access_key: str):
        if access_key == "reader":
            return Credentials("reader", "readersecret")
        return super().get_credentials(access_key)


@pytest.mark.parametrize("pkg", PKGS)
def test_config_routes_need_a_signature(tmp_path, pkg):
    srv, _ = _s3server(pkg, tmp_path)
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)
        for route in ("get-config-kv", "help-config-kv",
                      "list-config-history-kv"):
            st, _, body = c.request("GET", f"/minio/admin/v3/{route}",
                                    anonymous=True)
            assert st == 403 and b"AccessDenied" in body
    finally:
        srv.stop()


def test_config_routes_need_config_update(tmp_path):
    """A signed key without admin:ConfigUpdate is refused."""
    srv, _ = _s3server(PORT, tmp_path)
    try:
        srv.iam = srv.admin.iam = _Reader(ACCESS, SECRET)
        c = S3Client(srv.endpoint, "reader", "readersecret")
        st, _, body = c.request("PUT", "/minio/admin/v3/set-config-kv",
                                body=b"api requests_max=1")
        assert st == 403 and b"admin:ConfigUpdate" in body
    finally:
        srv.stop()


def _server(pkg, root):
    """tests/test_config_history.py's Server (4 drives); the port's runs
    its S3 plane alone."""
    if pkg == JAX:
        return JaxServer([str(root / "disk{1...4}")], port=0,
                         root_user="cfgak", root_password="cfgsecret",
                         enable_scanner=False).start()
    srv = Server([str(root / "disk{1...4}")], port=0, root_user="cfgak",
                 root_password="cfgsecret", device="cpu")
    srv.s3.start()
    return srv


@pytest.mark.parametrize("pkg", PKGS)
def test_admin_history_endpoints(tmp_path, pkg):
    srv = _server(pkg, tmp_path)
    try:
        c = S3Client(srv.endpoint, "cfgak", "cfgsecret")
        for delay in (b"20", b"30"):
            st, _, _ = c.request("PUT", "/minio/admin/v3/set-config-kv",
                                 body=b"scanner delay=" + delay)
            assert st == 200
        st, _, body = c.request("GET",
                                "/minio/admin/v3/list-config-history-kv",
                                [("with-data", "true")])
        assert st == 200
        hist = json.loads(body)
        assert len(hist) == 2
        assert all("restoreId" in e and "kv" in e for e in hist)
        oldest = hist[-1]["restoreId"]
        st, _, body = c.request("PUT",
                                "/minio/admin/v3/restore-config-history-kv",
                                [("restoreId", oldest)])
        assert st == 200, body
        st, _, body = c.request("GET", "/minio/admin/v3/get-config-kv",
                                [("key", "scanner")])
        assert json.loads(body)["scanner"]["delay"] == "20"
        st, _, body = c.request("PUT",
                                "/minio/admin/v3/restore-config-history-kv",
                                [("restoreId", "2020-bogus.kv")])
        assert st == 404
    finally:
        srv.stop()


# --- tests/test_conformance.py::test_requests_max_throttle --------------

@pytest.mark.parametrize("pkg", PKGS)
def test_requests_max_throttle(tmp_path, pkg):
    """api requests_max bounds concurrent S3 requests; a waiter past
    requests_deadline gets 503 SlowDown."""
    srv, _ = _s3server(pkg, tmp_path, {
        "api": {"requests_max": "1", "requests_deadline": "1s"}})
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)
        assert c.request("PUT", "/thrbkt")[0] == 200
        assert srv._requests_sem.acquire(timeout=5)
        try:
            t0 = _time.monotonic()
            st, _, body = c.request("GET", "/thrbkt")
            waited = _time.monotonic() - t0
            assert st == 503 and b"<Code>SlowDown</Code>" in body
            assert waited >= 0.9
        finally:
            srv._requests_sem.release()
        assert c.request("GET", "/thrbkt")[0] == 200
    finally:
        srv.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_bad_deadline_keeps_the_limit(tmp_path, pkg):
    """The two api keys are parsed apart: a bad deadline keeps the
    default 10 s and the limit."""
    srv, _ = _s3server(pkg, tmp_path, {
        "api": {"requests_max": "2", "requests_deadline": "soon"}})
    try:
        assert srv._requests_sem is not None
        assert srv._requests_deadline_s == 10.0
    finally:
        srv.stop()


def test_throttle_slot_held_through_a_streamed_get(tmp_path):
    """The port's slot covers a GET until its body is written."""
    srv, _ = _s3server(PORT, tmp_path, {
        "api": {"requests_max": "1", "requests_deadline": "200ms"}})
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)
        assert c.request("PUT", "/slb")[0] == 200
        assert c.request("PUT", "/slb/o", body=b"z" * 300_000)[0] == 200
        got = []

        def slow_sink(piece):
            got.append(piece)
            _time.sleep(0.05)

        t = threading.Thread(target=c.get_stream, args=("/slb/o", slow_sink))
        t.start()
        _time.sleep(0.02)
        other = S3Client(srv.endpoint, ACCESS, SECRET)
        st = other.request("HEAD", "/slb/o")[0]
        t.join()
        assert b"".join(got) == b"z" * 300_000
        assert st in (200, 503)
        assert other.request("HEAD", "/slb/o")[0] == 200
    finally:
        srv.stop()


# --- CORS ----------------------------------------------------------------

def _cors(c, origin):
    st, h, _ = c.request("OPTIONS", "/b", headers={"Origin": origin},
                         anonymous=True)
    pre = (st, h.get("Access-Control-Allow-Origin"), h.get("Vary"),
           h.get("Access-Control-Allow-Methods"))
    st, h, _ = c.request("GET", "/", headers={"Origin": origin})
    return pre, (st, h.get("Access-Control-Allow-Origin"), h.get("Vary"))


@pytest.mark.parametrize("allow", ["*", "https://*.example.com,https://x.io"])
def test_cors_allow_origin(tmp_path, allow):
    answers = {}
    for pkg in PKGS:
        srv, _ = _s3server(pkg, tmp_path / pkg,
                           {"api": {"cors_allow_origin": allow}})
        try:
            c = S3Client(srv.endpoint, ACCESS, SECRET)
            answers[pkg] = [_cors(c, o) for o in (
                "https://app.example.com", "https://x.io", "https://evil",
                "")]
        finally:
            srv.stop()
    assert answers[PORT] == answers[JAX]
    if allow != "*":
        assert answers[PORT][0][0][1] == "https://app.example.com"
        assert answers[PORT][2][0][1] is None


# --- drive and heal ------------------------------------------------------

_ROBUST_FIELDS = ("enabled", "op_deadline_s", "long_op_deadline_s",
                  "hedge_delay_s", "straggler_grace_s", "breaker_threshold",
                  "probe_interval_s", "max_inflight")


@pytest.fixture
def robust_restored():
    """Both packages' live drive settings put back after the case."""
    old = [{f: getattr(m.ROBUST, f) for f in _ROBUST_FIELDS}
           for m in (dc, jax_dc)]
    yield
    for m, vals in zip((dc, jax_dc), old):
        for f, v in vals.items():
            setattr(m.ROBUST, f, v)


def test_drive_env_reaches_disk_health(tmp_path, monkeypatch,
                                       robust_restored):
    """MTPU_DRIVE_* at start, then the stored `drive` subsystem after a
    restart: the port's drives' deadlines follow minio_tpu's."""
    monkeypatch.setenv("MTPU_DRIVE_OP_DEADLINE", "7s")
    monkeypatch.setenv("MTPU_DRIVE_MAX_INFLIGHT", "5")
    seen = {}
    for pkg in PKGS:
        srv = _server(pkg, tmp_path / pkg)
        try:
            robust = (dc if pkg == PORT else jax_dc).ROBUST
            seen[pkg] = [(robust.op_deadline_s, robust.max_inflight)]
            c = S3Client(srv.endpoint, "cfgak", "cfgsecret")
            assert c.request("PUT", "/minio/admin/v3/set-config-kv",
                             body=b"drive long_op_deadline=45s "
                                  b"breaker_threshold=6")[0] == 200
        finally:
            srv.stop()
    monkeypatch.delenv("MTPU_DRIVE_OP_DEADLINE")
    for pkg in PKGS:
        srv = _server(pkg, tmp_path / pkg)
        try:
            robust = (dc if pkg == PORT else jax_dc).ROBUST
            seen[pkg].append((robust.op_deadline_s, robust.long_op_deadline_s,
                              robust.breaker_threshold))
            if pkg == PORT:
                health = srv.object_layer.pools[0].sets[0].disks[0].health
                assert health.cfg is dc.ROBUST
                assert health.cfg.long_op_deadline_s == 45.0
        finally:
            srv.stop()
    assert seen[PORT] == seen[JAX] == [(7.0, 5), (30.0, 45.0, 6)]


def test_heal_subsystem_sets_gate_and_pause(tmp_path):
    srv, cs = _s3server(PORT, tmp_path)
    jsrv, jcs = _s3server(JAX, tmp_path / "jax")
    try:
        for s in (cs, jcs):
            s.config.set_kv("heal", max_io="3", max_sleep="500ms")
        assert srv.admin._heal_max_io() == 3
        assert srv.admin._heal_max_sleep_s() == \
            jsrv.admin._heal_max_sleep_s() == 0.005
        for s in (cs, jcs):
            s.config.del_target("heal")
        assert srv.admin._heal_max_io() == 10
        assert srv.admin._heal_max_sleep_s() == \
            jsrv.admin._heal_max_sleep_s() == 0.01
    finally:
        srv.stop()
        jsrv.stop()


def test_heal_io_gate_waits_on_max_io(tmp_path, monkeypatch):
    """The admin heal's gate is make_io_gate over the requests in flight
    with the configured max_io."""
    srv, cs = _s3server(PORT, tmp_path)
    seen = []
    from minio_tpu_torch.api import admin as admin_mod

    def gate(inflight, max_io):
        seen.append(max_io)
        return None

    monkeypatch.setattr(admin_mod, "make_io_gate", gate)
    try:
        cs.config.set_kv("heal", max_io="2")
        c = S3Client(srv.endpoint, ACCESS, SECRET)
        assert c.request("PUT", "/healbkt")[0] == 200
        st, _, _ = c.request("POST", "/minio/admin/v3/heal/healbkt")
        assert st == 200 and seen == [2]
    finally:
        srv.stop()


def test_restored_config_reaches_the_handlers(tmp_path):
    """After restore-config-history-kv the port's handlers read the
    restored config at once; minio_tpu's keep the Config object they were
    built with until a restart (ROADMAP.md Queue 3), so the same PUT is
    compressed on the port and stored plain on minio_tpu."""
    stored = {}
    for pkg in PKGS:
        srv, cs = _s3server(pkg, tmp_path / pkg)
        try:
            c = S3Client(srv.endpoint, ACCESS, SECRET)
            for body in (b"compression enable=on extensions=.log",
                         b"compression enable=off"):
                assert c.request("PUT", "/minio/admin/v3/set-config-kv",
                                 body=body)[0] == 200
            hist = json.loads(c.request(
                "GET", "/minio/admin/v3/list-config-history-kv")[2])
            assert c.request("PUT",
                             "/minio/admin/v3/restore-config-history-kv",
                             [("restoreId", hist[-1]["restoreId"])])[0] \
                == 200
            assert cs.config.get("compression")["enable"] == "on"
            assert c.request("PUT", "/rst")[0] == 200
            body = b"restored settings " * 4000
            assert c.request("PUT", "/rst/a.log", body=body)[0] == 200
            assert c.request("GET", "/rst/a.log")[2] == body
            disk = srv.handlers.ol.pools[0].sets[0].disks[0]
            stored[pkg] = "x-mtpu-internal-compression" in disk.read_version(
                "rst", "a.log").metadata
        finally:
            srv.stop()
    assert stored == {PORT: True, JAX: False}

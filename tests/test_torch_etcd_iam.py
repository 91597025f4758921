"""The etcd back end of the IAM store (minio_tpu_torch/iam/etcd.py) against
minio_tpu's (minio_tpu/iam/etcd.py), case for case with
tests/test_etcd_iam.py, over that file's FakeEtcd (the v3 JSON gateway
in this process): the KV round trips and prefix queries, an unreachable
endpoint, the IAM store's keys, the watch that reloads another
instance, the debounced reload and the STS credentials a reload keeps.

Each case runs on both packages; where both write to etcd, the keys and
values they leave compare byte for byte (secrets seeded alike).
"""

import base64
import json
import random
import time

import pytest

from minio_tpu.iam import IAMSys as JaxIAMSys
from minio_tpu.iam import etcd as jax_etcd
from minio_tpu.iam import store as jax_store
from minio_tpu.iam.policy import Policy as JaxPolicy
from minio_tpu_torch.iam import etcd as port_etcd
from minio_tpu_torch.iam import store as port_store
from minio_tpu_torch.iam.policy import Policy as PortPolicy
from minio_tpu_torch.iam.store import IAMSys as PortIAMSys
from tests.test_etcd_iam import FakeEtcd

PORT, JAX = "port", "jax"
PKGS = (JAX, PORT)
MODS = {PORT: (port_etcd, PortIAMSys, PortPolicy),
        JAX: (jax_etcd, JaxIAMSys, JaxPolicy)}
READERS = json.dumps({
    "Version": "2012-10-17",
    "Statement": [{"Effect": "Allow", "Action": ["s3:GetObject"],
                   "Resource": ["arn:aws:s3:::*"]}]})


@pytest.fixture()
def etcd():
    srv = FakeEtcd()
    yield srv
    srv.stop()


def _seed_secrets(monkeypatch):
    """Both packages' generate_credentials draw from one seeded stream."""
    rng = random.Random(19)
    shim = type("S", (), {
        "choice": staticmethod(lambda seq: seq[rng.randrange(len(seq))]),
        "token_urlsafe": staticmethod(
            lambda n=32: base64.urlsafe_b64encode(
                rng.randbytes(n)).rstrip(b"=").decode()),
    })
    for mod in (port_store, jax_store):
        monkeypatch.setattr(mod, "secrets", shim)


def _wait_for(cond, timeout_s: float = 10.0) -> bool:
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


@pytest.mark.parametrize("pkg", PKGS)
def test_prefix_range_end(pkg):
    etcd_mod = MODS[pkg][0]
    assert etcd_mod._prefix_range_end(b"abc") == b"abd"
    assert etcd_mod._prefix_range_end(b"a\xff") == b"b"
    assert etcd_mod._prefix_range_end(b"\xff") == b"\x00"


@pytest.mark.parametrize("pkg", PKGS)
def test_kv_roundtrip_and_prefix(etcd, pkg):
    kv = MODS[pkg][0].EtcdKV([etcd.endpoint])
    kv.put(b"config/iam/users/a.json", b"A")
    kv.put(b"config/iam/users/b.json", b"B")
    kv.put(b"config/iam/policies/p.json", b"P")
    assert kv.get(b"config/iam/users/a.json") == b"A"
    assert kv.get(b"missing") is None
    assert kv.get_prefix(b"config/iam/users/") == {
        b"config/iam/users/a.json": b"A",
        b"config/iam/users/b.json": b"B"}
    kv.delete(b"config/iam/users/a.json")
    assert kv.get(b"config/iam/users/a.json") is None
    kv.delete_prefix(b"config/iam/")
    assert kv.get_prefix(b"config/iam/") == {}


@pytest.mark.parametrize("pkg", PKGS)
def test_kv_unreachable_raises(pkg):
    etcd_mod = MODS[pkg][0]
    with pytest.raises(etcd_mod.EtcdError):
        etcd_mod.EtcdKV(["127.0.0.1:1"], timeout=0.3).put(b"k", b"v")
    with pytest.raises(etcd_mod.EtcdError):
        etcd_mod.EtcdKV([])


def _crud(etcd, pkg) -> dict:
    etcd_mod, iam_cls, policy_cls = MODS[pkg]
    kv = etcd_mod.EtcdKV([etcd.endpoint])
    iam = iam_cls("rootak", "rootsk",
                  store=etcd_mod.EtcdIAMBackend(kv, path_prefix="cluster1"))
    iam.add_user("alice", "alice-secret-key")
    iam.set_policy("readers", policy_cls.parse(READERS))
    iam.attach_policy("alice", ["readers"])
    iam.new_service_account("alice")
    iam.add_group_members("auditors", ["alice"])
    keys = dict(etcd.kv)
    iam2 = iam_cls("rootak", "rootsk",
                   store=etcd_mod.EtcdIAMBackend(kv, path_prefix="cluster1"))
    iam2.load()
    loaded = (iam2.get_credentials("alice").secret_key,
              iam2.user_policy["alice"], "readers" in iam2.policies,
              iam2.groups_of("alice"))
    iam.delete_user("alice")
    return {"keys": keys, "loaded": loaded, "after_delete": dict(etcd.kv)}


def test_iam_crud_persists_in_etcd(etcd, monkeypatch):
    """tests/test_etcd_iam.py's CRUD case on both packages: the keys under
    the prefix's layout, a second instance loading them, the delete
    reaching etcd; each package's keys and values byte for byte equal."""
    runs = {}
    for pkg in PKGS:
        etcd.kv.clear()
        with monkeypatch.context() as mp:
            _seed_secrets(mp)
            runs[pkg] = _crud(etcd, pkg)
    assert runs[PORT] == runs[JAX]
    keys = runs[PORT]["keys"]
    assert b"cluster1/config/iam/users/alice.json" in keys
    assert b"cluster1/config/iam/policies/readers.json" in keys
    assert runs[PORT]["loaded"] == ("alice-secret-key", ["readers"], True,
                                    ["auditors"])
    assert (b"cluster1/config/iam/users/alice.json"
            not in runs[PORT]["after_delete"])


@pytest.mark.parametrize("pkg", PKGS)
def test_watch_invalidation_across_instances(etcd, pkg):
    """Node B's IAM reloads through the etcd watch when node A writes."""
    etcd_mod, iam_cls, _ = MODS[pkg]
    iam_a = iam_cls("rootak", "rootsk", store=etcd_mod.EtcdIAMBackend(
        etcd_mod.EtcdKV([etcd.endpoint])))
    iam_b = iam_cls("rootak", "rootsk", store=etcd_mod.EtcdIAMBackend(
        etcd_mod.EtcdKV([etcd.endpoint])))
    iam_b.load()
    watcher = iam_b.store.start_watch(iam_b.reload)
    try:
        assert _wait_for(lambda: bool(etcd._watchers), 5)
        assert iam_b.get_credentials("bob") is None
        iam_a.add_user("bob", "bob-secret-key-1")
        assert _wait_for(lambda: iam_b.get_credentials("bob") is not None)
        assert iam_b.get_credentials("bob").secret_key == "bob-secret-key-1"
        iam_a.delete_user("bob")
        assert _wait_for(lambda: iam_b.get_credentials("bob") is None)
    finally:
        watcher.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_reload_does_not_resurrect_sts_prefixed_admin_policy(etcd, pkg):
    etcd_mod, iam_cls, policy_cls = MODS[pkg]
    iam = iam_cls("rootak", "rootsk", store=etcd_mod.EtcdIAMBackend(
        etcd_mod.EtcdKV([etcd.endpoint])))
    p1 = policy_cls.parse(READERS)
    iam.set_policy("sts-audit", p1)
    iam.delete_policy("sts-audit")  # gone from the store
    iam.policies["sts-audit"] = p1  # stale in another instance's memory
    iam.reload()
    assert "sts-audit" not in iam.policies


@pytest.mark.parametrize("pkg", PKGS)
def test_watch_burst_debounces_reloads(etcd, pkg):
    etcd_mod, iam_cls, _ = MODS[pkg]
    backend = etcd_mod.EtcdIAMBackend(etcd_mod.EtcdKV([etcd.endpoint]))
    calls = []
    watcher = backend.start_watch(lambda: calls.append(time.time()))
    try:
        assert _wait_for(lambda: bool(etcd._watchers), 5)
        writer = iam_cls("rootak", "rootsk", store=etcd_mod.EtcdIAMBackend(
            etcd_mod.EtcdKV([etcd.endpoint])))
        for i in range(20):
            writer.add_user(f"u{i:02d}", f"secret-key-{i:02d}xx")
        assert _wait_for(lambda: bool(calls), 5)
        time.sleep(0.5)  # stragglers coalesce
        assert 1 <= len(calls) < 10, len(calls)
    finally:
        watcher.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_sts_survives_watch_reload(etcd, pkg):
    etcd_mod, iam_cls, policy_cls = MODS[pkg]
    iam = iam_cls("rootak", "rootsk", store=etcd_mod.EtcdIAMBackend(
        etcd_mod.EtcdKV([etcd.endpoint])))
    iam.add_user("carol", "carol-secret-key")
    temp = iam.new_sts_credentials(
        "carol", duration_s=600, session_policy=policy_cls.parse(READERS))
    iam.reload()
    got = iam.get_credentials(temp.access_key)
    assert got is not None and got.parent_user == "carol"
    assert f"sts-{temp.access_key}" in iam.policies
    assert iam.get_credentials("carol") is not None


@pytest.mark.parametrize("pkg", PKGS)
def test_server_picks_etcd_from_the_env(etcd, tmp_path, monkeypatch, pkg):
    """MTPU_ETCD_ENDPOINTS (the env form of the `etcd` subsystem) puts a
    Server's IAM in etcd, with a watch that stops with the server; the
    root's admin add-user lands under the path prefix."""
    from minio_tpu_torch.api.client import S3Client

    monkeypatch.setenv("MTPU_ETCD_ENDPOINTS", etcd.endpoint)
    monkeypatch.setenv("MTPU_ETCD_PATH_PREFIX", "tenant")
    if pkg == PORT:
        from minio_tpu_torch.server import Server

        srv = Server([str(tmp_path / "d{1...4}")], port=0,
                     root_user="etcdak", root_password="etcdsecret",
                     device="cpu")
        srv.s3.start()
    else:
        from minio_tpu.server import Server as JaxServer

        srv = JaxServer([str(tmp_path / "d{1...4}")], port=0,
                        root_user="etcdak", root_password="etcdsecret",
                        enable_scanner=False).start()
    try:
        assert isinstance(srv.iam.store, MODS[pkg][0].EtcdIAMBackend)
        c = S3Client(srv.endpoint, "etcdak", "etcdsecret")
        st, _, _ = c.request("PUT", "/minio/admin/v3/add-user",
                             [("accessKey", "dave")],
                             body=b'{"secretKey": "dave-secret-key"}')
        assert st == 200
        assert json.loads(etcd.kv[b"tenant/config/iam/users/dave.json"])[
            "secretKey"] == "dave-secret-key"
        assert srv._iam_watcher is not None
    finally:
        srv.stop()

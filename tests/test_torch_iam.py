"""The port's IAM (minio_tpu_torch/iam/store.py and the identity admin
routes of api/admin.py) against minio_tpu's, on the CPU.

- `is_allowed` gives the same verdict on a grid of principals (the root,
  a user with an explicit Deny, a group member, a disabled user, service
  accounts of a user and of the root, STS credentials with no session
  policy, a narrowing one and one that would widen, a federated
  credential, an unknown key) against actions and resources; and
  `get_credentials` the same credential or none.
- The `.minio.sys/config/iam/*` blobs that each package's
  ObjectStoreBackend writes for the same operations compare byte for
  byte, and so do the drive files under them (ids, clocks and the
  generated keys made alike).
- `reload` keeps the live STS credentials, their mappings and session
  policies, and reads the rest from the store.
- Over HTTP on both packages' S3Servers (4 drives, one set, the IAM in
  the object layer): the identity admin routes, a user's and a disabled
  user's requests, a group member's and a service account's, and the
  replica marker's s3:ReplicateObject, case for case: statuses, bodies,
  error codes and the drive files.
- Where the port differs on purpose (ROADMAP.md Queue 3): a user granted
  s3:DeleteObject but not s3:BypassGovernanceRetention deletes a
  GOVERNANCE version with the bypass header on minio_tpu (204) and not
  on the port (403); a reload whose store read fails, and a decision
  made while a reload reads the store, widen an STS credential of the
  root's and lock users out on minio_tpu and not on the port; a lost
  read quorum under ObjectStoreBackend loads nothing on minio_tpu, and
  its next mapping write drops the others' mappings, where the port's
  load raises.
"""

import json
import threading
import time

import pytest
import torch

import tests.test_torch_objectlock_quota as lockq
from minio_tpu.api import S3Server as JaxS3Server
from minio_tpu.bucket import BucketMetadataSys as JaxBucketMetadataSys
from minio_tpu.iam import IAMStore as JaxIAMStore
from minio_tpu.iam import IAMSys as JaxIAMSys
from minio_tpu.iam import ObjectStoreBackend as JaxObjectStoreBackend
from minio_tpu.iam.policy import Args as JaxArgs
from minio_tpu.iam.policy import Policy as JaxPolicy
from minio_tpu.object.pools import ErasureServerPools as JaxPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu_torch.api.client import S3Client
from minio_tpu_torch.api.server import S3Server
from minio_tpu_torch.bucket.metadata import BucketMetadataSys
from minio_tpu_torch.iam import IAMStore, ObjectStoreBackend
from minio_tpu_torch.iam.policy import Args, Policy
from minio_tpu_torch.iam.store import IAMSys
from minio_tpu_torch.object.pools import ErasureServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.storage.local import LocalStorage
from tests.test_torch_compression import env  # noqa: F401 - fixture
from tests.test_torch_etcd_iam import _seed_secrets
from tests.test_torch_s3_core import _alike, _record, _tree

torch.set_num_threads(1)

PORT, JAX = "port", "jax"
PKGS = (JAX, PORT)
ACCESS, SECRET = "tpuadmin", "tpuadmin-secret-key"
DEPLOYMENT = "5ba52d31-4f2e-4d69-92f5-926a51824e19"
ADMIN = "/minio/admin/v3"
KINDS = {PORT: (IAMSys, Policy, Args, ObjectStoreBackend),
         JAX: (JaxIAMSys, JaxPolicy, JaxArgs, JaxObjectStoreBackend)}


def _doc(effect: str, actions: list, resources: list) -> str:
    return json.dumps({"Version": "2012-10-17", "Statement": [{
        "Effect": effect, "Action": actions, "Resource": resources}]})


DATA_RW = _doc("Allow", ["s3:PutObject", "s3:GetObject", "s3:ListBucket"],
               ["arn:aws:s3:::data", "arn:aws:s3:::data/*"])
REPORTS_RO = _doc("Allow", ["s3:GetObject"], ["arn:aws:s3:::reports/*"])
DENY_SECRET = _doc("Deny", ["s3:*"], ["arn:aws:s3:::data/secret/*"])
GET_DATA = _doc("Allow", ["s3:GetObject"], ["arn:aws:s3:::data/*"])
EVERYTHING = _doc("Allow", ["s3:*", "admin:*"], ["arn:aws:s3:::*"])


# --- is_allowed on a grid ------------------------------------------------

def _grid_iam(pkg: str, store=None):
    """An IAMSys of `pkg` with one principal of each kind; returns it and
    {principal: access key}."""
    iam_cls, policy_cls, _, _ = KINDS[pkg]
    iam = iam_cls(ACCESS, SECRET, store=store)
    for name, doc in (("data-rw", DATA_RW), ("reports-ro", REPORTS_RO),
                      ("deny-secret", DENY_SECRET)):
        iam.set_policy(name, policy_cls.parse(doc))
    iam.add_user("alice", "alice-secret-key")
    iam.attach_policy("alice", ["data-rw", "deny-secret"])
    iam.add_user("bob", "bob-secret-key")
    iam.add_group_members("auditors", ["bob"])
    iam.attach_policy("auditors", ["reports-ro"], is_group=True)
    iam.add_user("carol", "carol-secret-key", status="off")
    iam.attach_policy("carol", ["readwrite"])
    keys = {"root": ACCESS, "alice": "alice", "bob": "bob",
            "carol_disabled": "carol", "unknown": "nobody"}
    keys["sa_alice"] = iam.new_service_account("alice").access_key
    keys["sa_root"] = iam.new_service_account(ACCESS).access_key
    keys["sts_alice"] = iam.new_sts_credentials("alice").access_key
    keys["sts_narrowed"] = iam.new_sts_credentials(
        "alice", session_policy=policy_cls.parse(GET_DATA)).access_key
    keys["sts_widened"] = iam.new_sts_credentials(
        "bob", session_policy=policy_cls.parse(EVERYTHING)).access_key
    keys["federated"] = iam.new_federated_credentials(
        "user@idp", 900, ["reports-ro"]).access_key
    return iam, keys


GRID_ACTIONS = ("s3:GetObject", "s3:PutObject", "s3:ListBucket",
                "s3:DeleteObject", "s3:BypassGovernanceRetention",
                "admin:CreateUser")
GRID_RESOURCES = (("data", "x"), ("data", "secret/k"), ("data", ""),
                  ("reports", "q1"), ("other", "y"))
PRINCIPALS = ("root", "alice", "bob", "carol_disabled", "unknown",
              "sa_alice", "sa_root", "sts_alice", "sts_narrowed",
              "sts_widened", "federated")


def _verdicts(pkg: str, principal: str, mp) -> dict:
    _seed_secrets(mp)
    iam, keys = _grid_iam(pkg)
    args_cls = KINDS[pkg][2]
    ak = keys[principal]
    out = {(a, b, o): iam.is_allowed(args_cls(account=ak, action=a,
                                              bucket=b, object=o))
           for a in GRID_ACTIONS for b, o in GRID_RESOURCES}
    cred = iam.get_credentials(ak)
    out["credential"] = None if cred is None else (
        cred.access_key, cred.secret_key, cred.parent_user,
        cred.is_temp(), cred.is_service_account())
    return out


@pytest.mark.parametrize("principal", PRINCIPALS)
def test_is_allowed_grid(principal, monkeypatch):
    runs = {}
    for pkg in PKGS:
        with monkeypatch.context() as mp:
            runs[pkg] = _verdicts(pkg, principal, mp)
    assert runs[PORT] == runs[JAX]
    got = runs[PORT]
    expect = {
        "root": ("admin:CreateUser", "other", "y", True),
        "alice": ("s3:GetObject", "data", "secret/k", False),
        "bob": ("s3:GetObject", "reports", "q1", True),
        "sa_alice": ("s3:PutObject", "data", "x", True),
        "sts_narrowed": ("s3:PutObject", "data", "x", False),
        "sts_widened": ("s3:PutObject", "data", "x", False),
        "federated": ("s3:GetObject", "reports", "q1", True),
        "unknown": ("s3:GetObject", "data", "x", False),
    }.get(principal)
    if expect is not None:
        action, bucket, obj, verdict = expect
        assert got[(action, bucket, obj)] is verdict
    if principal in ("carol_disabled", "unknown"):
        assert got["credential"] is None


# --- the persisted blobs --------------------------------------------------

def _object_layer(pkg: str, root):
    """4 fresh drives, one set, the object layer of `pkg`."""
    if pkg == PORT:
        disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}",
                              device="cpu") for i in range(4)]
        sets = ErasureSets(disks, 4, deployment_id=DEPLOYMENT,
                           device="cpu")
        sets.init_format()
        return ErasureServerPools([sets], device="cpu")
    disks = [JaxLocalStorage(str(root / f"d{i}"), endpoint=f"d{i}")
             for i in range(4)]
    sets = JaxErasureSets(disks, 4, deployment_id=DEPLOYMENT)
    sets.init_format()
    return JaxPools([sets])


def _iam_tree(root) -> dict:
    return {k: v for k, v in _tree(root).items()
            if "/.minio.sys/config/iam/" in f"/{k}"}


def test_blobs_equal_byte_for_byte(env, tmp_path):  # noqa: F811
    """The same operations through each package's ObjectStoreBackend:
    every blob under .minio.sys/config/iam equal, and every drive file
    under it, after writes, a status change and deletes."""
    runs = {}
    for pkg in PKGS:
        with pytest.MonkeyPatch.context() as mp:
            clock = _alike(mp)
            _seed_secrets(mp)
            ol = _object_layer(pkg, tmp_path / pkg)
            store = KINDS[pkg][3](ol)
            iam, keys = _grid_iam(pkg, store=store)
            clock.now += 10 ** 9
            iam.set_user_status("bob", "off")
            iam.delete_policy("deny-secret")
            iam.remove_group_members("auditors", ["bob"])
            iam.add_user("dave", "dave-secret-key")
            iam.delete_user("dave")
            blobs = {p: store.load(p) for p in store.list("")}
            runs[pkg] = {"blobs": blobs, "tree": _iam_tree(tmp_path / pkg),
                         "keys": keys}
    assert runs[PORT]["keys"] == runs[JAX]["keys"]
    assert runs[PORT]["blobs"] == runs[JAX]["blobs"]
    assert set(runs[PORT]["blobs"]) >= {
        "policy-mappings.json", "policies/data-rw.json",
        "users/alice.json", f"users/{runs[PORT]['keys']['sa_alice']}.json"}
    assert "policies/deny-secret.json" not in runs[PORT]["blobs"]
    jax, port = runs[JAX]["tree"], runs[PORT]["tree"]
    assert port.keys() == jax.keys() and port
    assert [k for k in jax if port[k] != jax[k]] == []
    # The secret keys are stored in clear on both (ROADMAP.md Queue 3).
    assert json.loads(runs[PORT]["blobs"]["users/alice.json"])[
        "secretKey"] == "alice-secret-key"


@pytest.mark.parametrize("pkg", PKGS)
def test_reload_keeps_live_sts_credentials(env, tmp_path, pkg):  # noqa: F811
    iam_cls, policy_cls, _, backend = KINDS[pkg]
    iam = iam_cls(ACCESS, SECRET,
                  store=backend(_object_layer(pkg, tmp_path)))
    iam.set_policy("reports-ro", policy_cls.parse(REPORTS_RO))
    iam.add_user("erin", "erin-secret-key")
    narrowed = iam.new_sts_credentials(
        "erin", duration_s=600, session_policy=policy_cls.parse(GET_DATA))
    fed = iam.new_federated_credentials("sub", 600, ["reports-ro"])
    mappings = json.loads(iam.store.load("policy-mappings.json") or b"{}")
    assert fed.access_key not in mappings.get("users", {})
    # A write the instance did not make: the store's copy wins on reload.
    other = iam_cls(ACCESS, SECRET, store=iam.store)
    other.load()
    other.add_user("frank", "frank-secret-key")
    iam.reload()
    assert iam.get_credentials(narrowed.access_key).parent_user == "erin"
    assert f"sts-{narrowed.access_key}" in iam.policies
    assert iam.user_policy[fed.access_key] == ["reports-ro"]
    assert iam.get_credentials("frank").secret_key == "frank-secret-key"
    # A fresh instance on the same store: the STS credentials are gone.
    fresh = iam_cls(ACCESS, SECRET, store=iam.store)
    fresh.load()
    assert fresh.get_credentials(narrowed.access_key) is None
    assert fresh.get_credentials("erin") is not None


# --- over HTTP on both packages --------------------------------------------

def _iam_server(pkg: str, root):
    ol = _object_layer(pkg, root)
    if pkg == PORT:
        return S3Server(ol, IAMSys(ACCESS, SECRET,
                                   store=ObjectStoreBackend(ol)),
                        BucketMetadataSys(ol), device="cpu").start()
    return JaxS3Server(ol, JaxIAMSys(ACCESS, SECRET,
                                     store=JaxObjectStoreBackend(ol)),
                       JaxBucketMetadataSys(ol)).start()


def _run(pkg: str, root, mp, case) -> dict:
    clock = _alike(mp)
    _seed_secrets(mp)
    srv = _iam_server(pkg, root)
    log = []
    try:
        root_client = S3Client(srv.endpoint, ACCESS, SECRET)

        def rec(*args, as_=None, **kw):
            clock.now += 10 ** 9
            resp = (as_ or root_client).request(*args, **kw)
            log.append(_record(resp))
            return resp

        case(rec, srv)
    finally:
        srv.stop()
    return {"log": log, "tree": _tree(root)}


def _user(srv, ak: str, sk: str) -> S3Client:
    return S3Client(srv.endpoint, ak, sk)


def case_admin_identity_routes(rec, srv):
    alice = _user(srv, "alice", "alice-secret-key")
    assert rec("PUT", "/data")[0] == 200
    assert rec("PUT", "/other")[0] == 200
    assert rec("PUT", f"{ADMIN}/add-canned-policy", [("name", "data-rw")],
               body=DATA_RW.encode())[0] == 200
    assert rec("PUT", f"{ADMIN}/add-canned-policy", [("name", "")],
               body=DATA_RW.encode())[0] == 400
    assert rec("PUT", f"{ADMIN}/add-canned-policy", [("name", "bad")],
               body=b"{not json")[0] == 400
    assert rec("PUT", f"{ADMIN}/add-user", [("accessKey", "alice")],
               body=json.dumps({"secretKey": "alice-secret-key"}).encode()
               )[0] == 200
    assert rec("PUT", f"{ADMIN}/add-user", [],
               body=b'{"secretKey": "x"}')[0] == 400
    assert rec("PUT", f"{ADMIN}/set-user-or-group-policy",
               [("userOrGroup", "alice"), ("policyName", "data-rw")]
               )[0] == 200
    assert rec("PUT", f"{ADMIN}/set-user-or-group-policy",
               [("userOrGroup", "devs"), ("policyName", "readonly"),
                ("isGroup", "true")])[0] == 200
    assert rec("PUT", f"{ADMIN}/set-user-or-group-policy",
               [("policyName", "readonly")])[0] == 400
    st, _, body = rec("GET", f"{ADMIN}/list-users")
    assert st == 200 and json.loads(body) == {
        "alice": {"status": "on", "policyName": "data-rw"}}
    st, _, body = rec("GET", f"{ADMIN}/list-canned-policies")
    assert st == 200 and "data-rw" in json.loads(body)
    # Alice's rights: her bucket, nothing else, no admin.
    assert rec("PUT", "/data/a", body=b"alice's", as_=alice)[0] == 200
    assert rec("GET", "/data/a", as_=alice)[2] == b"alice's"
    assert rec("GET", "/data", as_=alice)[0] == 200
    assert rec("PUT", "/other/a", body=b"x", as_=alice)[0] == 403
    assert rec("GET", f"{ADMIN}/list-users", as_=alice)[0] == 403
    assert rec("GET", "/", as_=alice)[0] == 403
    # Disabled, then enabled again.
    assert rec("PUT", f"{ADMIN}/set-user-status",
               [("accessKey", "alice"), ("status", "off")])[0] == 200
    st, _, body = rec("GET", "/data/a", as_=alice)
    assert st == 403 and b"InvalidAccessKeyId" in body
    assert rec("PUT", f"{ADMIN}/set-user-status",
               [("accessKey", "nobody"), ("status", "off")])[0] == 400
    assert rec("PUT", f"{ADMIN}/set-user-status",
               [("accessKey", "alice"), ("status", "on")])[0] == 200
    assert rec("GET", "/data/a", as_=alice)[0] == 200
    # The buckets' creation times are the drives' directory times: the
    # answer is checked here, not compared.
    st, _, body = _user(srv, ACCESS, SECRET).request(
        "GET", f"{ADMIN}/accountinfo")
    assert st == 200 and [b["name"] for b in json.loads(body)["buckets"]] \
        == ["data", "other"]
    # The policy removed, then the user.
    assert rec("DELETE", f"{ADMIN}/remove-canned-policy",
               [("name", "data-rw")])[0] == 200
    assert rec("PUT", "/data/b", body=b"x", as_=alice)[0] == 403
    assert rec("DELETE", f"{ADMIN}/remove-user",
               [("accessKey", "alice")])[0] == 200
    st, _, body = rec("GET", "/data/a", as_=alice)
    assert st == 403 and b"InvalidAccessKeyId" in body
    assert rec("GET", f"{ADMIN}/list-users")[2] == b"{}"
    assert rec("GET", f"{ADMIN}/list-users", anonymous=True)[0] == 403


def case_group_member_and_service_account(rec, srv):
    assert rec("PUT", "/data")[0] == 200
    assert rec("PUT", f"{ADMIN}/add-canned-policy", [("name", "data-rw")],
               body=DATA_RW.encode())[0] == 200
    assert rec("PUT", f"{ADMIN}/add-user", [("accessKey", "bob")],
               body=b'{"secretKey": "bob-secret-key"}')[0] == 200
    assert rec("PUT", f"{ADMIN}/set-user-or-group-policy",
               [("userOrGroup", "devs"), ("policyName", "data-rw"),
                ("isGroup", "true")])[0] == 200
    bob = _user(srv, "bob", "bob-secret-key")
    assert rec("PUT", "/data/g", body=b"x", as_=bob)[0] == 403
    srv.iam.add_group_members("devs", ["bob"])
    assert rec("PUT", "/data/g", body=b"group write", as_=bob)[0] == 200
    sa = srv.iam.new_service_account("bob")
    sac = _user(srv, sa.access_key, sa.secret_key)
    assert rec("GET", "/data/g", as_=sac)[2] == b"group write"
    assert rec("PUT", "/data/sa", body=b"by the account", as_=sac)[0] == 200
    assert rec("DELETE", "/data/sa", as_=sac)[0] == 403
    srv.iam.remove_group_members("devs", ["bob"])
    assert rec("GET", "/data/g", as_=sac)[0] == 403
    assert rec("GET", "/data/g", as_=bob)[0] == 403


def case_replica_marker_needs_replicate_object(rec, srv):
    marker = {"x-amz-meta-mtpu-replication": "replica"}
    assert rec("PUT", "/data")[0] == 200
    assert rec("PUT", f"{ADMIN}/add-canned-policy", [("name", "data-rw")],
               body=DATA_RW.encode())[0] == 200
    srv.iam.add_user("rita", "rita-secret-key")
    srv.iam.attach_policy("rita", ["data-rw"])
    rita = _user(srv, "rita", "rita-secret-key")
    st, _, body = rec("PUT", "/data/r", body=b"x", headers=marker, as_=rita)
    assert st == 403 and b"ReplicateObject" in body
    assert rec("PUT", "/data/r", body=b"plain", as_=rita)[0] == 200
    assert rec("PUT", "/data/root", body=b"x", headers=marker)[0] == 200


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_on_both_packages(env, tmp_path, name):  # noqa: F811
    runs = {}
    for pkg in PKGS:
        with pytest.MonkeyPatch.context() as mp:
            runs[pkg] = _run(pkg, tmp_path / pkg, mp, CASES[name])
    assert runs[PORT]["log"] == runs[JAX]["log"]
    jax, port = runs[JAX]["tree"], runs[PORT]["tree"]
    assert port.keys() == jax.keys()
    assert [k for k in jax if port[k] != jax[k]] == []


# --- where the port differs on purpose ------------------------------------

@pytest.mark.parametrize("granted", [False, True])
def test_governance_bypass_with_a_user(env, tmp_path, granted,  # noqa: F811
                                       monkeypatch):
    """A user granted s3:DeleteObject deletes a GOVERNANCE version with
    x-amz-bypass-governance-retention: minio_tpu reads the header alone
    (204), the port also asks for s3:BypassGovernanceRetention (403
    without it). Granted it, both delete."""
    monkeypatch.setattr(lockq, "T_NOW", time.time_ns() // 10 ** 9 * 10 ** 9)
    actions = ["s3:DeleteObject", "s3:PutObject", "s3:GetObject"] + (
        ["s3:BypassGovernanceRetention"] if granted else [])
    statuses = {}

    def case(rec, srv, pkg):
        lockq._mk_locked_bucket(rec, "wormu", lockq.RULE_GOVERNANCE_1D)
        _, h, _ = rec("PUT", "/wormu/gov", body=b"governed")
        vid = h["x-amz-version-id"]
        policy_cls = KINDS[pkg][1]
        srv.iam.set_policy("deleter", policy_cls.parse(_doc(
            "Allow", actions, ["arn:aws:s3:::wormu/*"])))
        srv.iam.add_user("gina", "gina-secret-key")
        srv.iam.attach_policy("gina", ["deleter"])
        gina = _user(srv, "gina", "gina-secret-key")
        statuses[pkg] = [
            gina.request("DELETE", "/wormu/gov", [("versionId", vid)])[0],
            gina.request("DELETE", "/wormu/gov", [("versionId", vid)],
                         headers=lockq.BYPASS)[0]]

    for pkg in PKGS:
        with pytest.MonkeyPatch.context() as mp:
            lockq._run(pkg, tmp_path / pkg, mp, case)
    assert statuses[JAX] == [403, 204]
    assert statuses[PORT] == ([403, 204] if granted else [403, 403])


def _gated_store(pkg: str):
    """A dict store of `pkg` whose reads can be made to fail (`fail`) or
    to wait for `gate` (`entered` is set when one waits)."""
    base = IAMStore if pkg == PORT else JaxIAMStore

    class Gated(base):
        fail = False
        gate = None
        entered = threading.Event()

        def load(self, path):
            if self.fail:
                raise OSError("store unreachable")
            if self.gate is not None:
                self.entered.set()
                self.gate.wait(30)
            return super().load(path)

    return Gated()


def _narrowed_root_sts(pkg: str):
    """An IAMSys of `pkg` over a gated store with alice (data-rw) and an
    STS credential of the root's narrowed to s3:GetObject on data."""
    iam_cls, policy_cls, args_cls, _ = KINDS[pkg]
    store = _gated_store(pkg)
    iam = iam_cls(ACCESS, SECRET, store=store)
    iam.set_policy("data-rw", policy_cls.parse(DATA_RW))
    iam.add_user("alice", "alice-secret-key")
    iam.attach_policy("alice", ["data-rw"])
    sts = iam.new_sts_credentials(
        ACCESS, session_policy=policy_cls.parse(GET_DATA))

    def allowed(account, action):
        return iam.is_allowed(args_cls(account=account, action=action,
                                       bucket="data", object="x"))

    return iam, store, sts.access_key, allowed


def test_failed_reload_keeps_the_state():
    """A reload whose store read fails (an etcd outage; the watcher logs
    it and keeps watching). minio_tpu has emptied its maps before the
    read: alice is locked out, and the root's STS credential loses its
    session policy, which widens it to the root's rights (PutObject
    allowed). The port keeps the state it had."""
    verdicts = {}
    for pkg in PKGS:
        iam, store, sts, allowed = _narrowed_root_sts(pkg)
        iam.reload()
        before = [allowed(sts, "s3:GetObject"), allowed(sts, "s3:PutObject"),
                  allowed("alice", "s3:PutObject")]
        store.fail = True
        with pytest.raises(OSError):
            iam.reload()
        verdicts[pkg] = (before, [
            allowed(sts, "s3:GetObject"), allowed(sts, "s3:PutObject"),
            allowed("alice", "s3:PutObject")])
    assert verdicts[JAX] == ([True, False, True], [True, True, False])
    assert verdicts[PORT] == ([True, False, True], [True, False, True])


def test_decision_during_a_reload():
    """is_allowed while a reload reads the store. minio_tpu answers at
    once from the emptied maps: the root's STS credential, narrowed to
    s3:GetObject, may PUT. The port's decision waits for the reload and
    denies."""
    results = {}
    for pkg in PKGS:
        iam, store, sts, allowed = _narrowed_root_sts(pkg)
        store.gate = threading.Event()
        reload = threading.Thread(target=iam.reload)
        reload.start()
        assert store.entered.wait(10)
        out = []
        decide = threading.Thread(
            target=lambda: out.append(allowed(sts, "s3:PutObject")))
        decide.start()
        decide.join(2)
        waited = decide.is_alive()
        store.gate.set()
        decide.join(10)
        reload.join(10)
        results[pkg] = (waited, out)
    assert results[JAX] == (False, [True])
    assert results[PORT] == (True, [False])


def test_lost_read_quorum_fails_the_load(env, tmp_path):  # noqa: F811
    """The IAM loaded over the object layer with 3 of 4 drives offline.
    minio_tpu reads the lost quorum as missing blobs and loads no user;
    once the drives are back, its next mapping write drops alice's
    mapping from the store for good. The port's load raises, and a load
    after the drives are back finds alice and her mapping."""
    runs = {}
    for pkg in PKGS:
        iam_cls, policy_cls, _, backend = KINDS[pkg]
        ol = _object_layer(pkg, tmp_path / pkg)
        iam = iam_cls(ACCESS, SECRET, store=backend(ol))
        iam.set_policy("data-rw", policy_cls.parse(DATA_RW))
        iam.add_user("alice", "alice-secret-key")
        iam.attach_policy("alice", ["data-rw"])
        disks = ol.pools[0].sets[0].disks
        for d in disks[1:]:
            d.set_online(False)
        restarted = iam_cls(ACCESS, SECRET, store=backend(ol))
        try:
            restarted.load()
            loaded = sorted(restarted.users)
        except Exception as exc:  # noqa: BLE001 - the error's name is kept
            loaded = type(exc).__name__
        for d in disks[1:]:
            d.set_online(True)
        if loaded == []:
            restarted.add_group_members("auditors", ["bob"])
        after = iam_cls(ACCESS, SECRET, store=backend(ol))
        after.load()
        runs[pkg] = (loaded, sorted(after.users), after.user_policy)
    assert runs[JAX] == ([], ["alice"], {})
    assert runs[PORT] == ("ErrErasureReadQuorum", ["alice"],
                          {"alice": ["data-rw"]})


def test_identity_routes_are_served():
    """None of the identity admin routes answers NotImplemented."""
    from minio_tpu_torch.api.admin import ACTIONS, _ROUTES

    names = {"list_users", "add_user", "remove_user", "set_user_status",
             "list_policies", "add_policy", "remove_policy",
             "set_policy_mapping", "account_info"}
    assert names <= set(_ROUTES.values())
    assert {ACTIONS[n] for n in names} == {
        "admin:ListUsers", "admin:CreateUser", "admin:DeleteUser",
        "admin:EnableUser", "admin:ListUserPolicies", "admin:CreatePolicy",
        "admin:DeletePolicy", "admin:AttachUserOrGroupPolicy",
        "admin:AccountInfo"}

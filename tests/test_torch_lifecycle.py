"""Bucket lifecycle (ILM) on the port against minio_tpu, on the CPU.

- The rule engine: each parse, validate and decision case of
  tests/test_lifecycle_engine.py and tests/test_lifecycle_versions.py
  runs through both packages' bucket/lifecycle.py, and the parsed rules,
  the decisions and the errors (type and message) must be equal.
- The scanner: each scanner case of those files runs on both packages,
  over 4 fresh drives of one set with the bucket metadata and a
  metrics registry, with ids and clocks made alike (the clock near the
  real time, as a retention is held to time.time()). What the listings
  show after the sweep, ilm_expired_total and every drive file must be
  equal.
- Where minio_tpu is at fault (ROADMAP.md Queue 3) the case asserts each
  side: its noncurrent-version sweep deletes a version under retention
  or legal hold, which MinIO keeps and the port keeps; and it expires a
  current version in a versioned bucket with no options, which finds no
  version and expires nothing, where MinIO and the port write a delete
  marker.
"""

import dataclasses
import io
import sys
import time
import types
import urllib.parse

import pytest
import torch

from minio_tpu.background import scanner as jax_scanner
from minio_tpu.bucket import BucketMetadataSys as JaxBucketMetadataSys
from minio_tpu.bucket import lifecycle as jax_lifecycle
from minio_tpu.object import erasure_objects as jax_eo
from minio_tpu.object.pools import ErasureServerPools as JaxPools
from minio_tpu.object.sets import ErasureSets as JaxSets
from minio_tpu.object.types import ObjectOptions as JaxOptions
from minio_tpu.observability import Metrics as JaxMetrics
from minio_tpu.storage.local import LocalStorage as JaxLocal
from minio_tpu_torch.background import scanner
from minio_tpu_torch.bucket import lifecycle
from minio_tpu_torch.bucket.metadata import BucketMetadataSys
from minio_tpu_torch.object import erasure_objects
from minio_tpu_torch.object.pools import ErasureServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.object.types import ObjectOptions
from minio_tpu_torch.observability import Metrics
from minio_tpu_torch.storage.local import LocalStorage
from tests.test_torch_s3_core import _alike, _Shim, _tree

torch.set_num_threads(1)

PORT, JAX = "port", "jax"
DEP = "abcdabcd-1111-2222-3333-abcdabcdabcd"
DAY_NS = 86400 * 10 ** 9
SMALL_BLOCK = 12 * 1024
# The clock of both sides near the real time (a retention is held to
# time.time()), set again for each test (`_now`).
T_NOW = time.time_ns() // 10 ** 9 * 10 ** 9
NOW = T_NOW / 1e9

MODS = {
    PORT: types.SimpleNamespace(
        lifecycle=lifecycle, scanner=scanner, Local=LocalStorage,
        Sets=ErasureSets, Pools=ErasureServerPools, Options=ObjectOptions,
        BM=BucketMetadataSys, Metrics=Metrics, kw={"device": "cpu"}),
    JAX: types.SimpleNamespace(
        lifecycle=jax_lifecycle, scanner=jax_scanner, Local=JaxLocal,
        Sets=JaxSets, Pools=JaxPools, Options=JaxOptions,
        BM=JaxBucketMetadataSys, Metrics=JaxMetrics, kw={}),
}

VERSIONED = ("<VersioningConfiguration><Status>Enabled</Status>"
             "</VersioningConfiguration>")
LC_XML = """<LifecycleConfiguration>
  <Rule><ID>nc</ID><Status>Enabled</Status>
    <Filter><Prefix></Prefix></Filter>
    <NoncurrentVersionExpiration><NoncurrentDays>7</NoncurrentDays>
    </NoncurrentVersionExpiration>
    <Expiration><ExpiredObjectDeleteMarker>true</ExpiredObjectDeleteMarker>
    </Expiration>
    <AbortIncompleteMultipartUpload><DaysAfterInitiation>3
    </DaysAfterInitiation></AbortIncompleteMultipartUpload>
  </Rule>
</LifecycleConfiguration>"""
RULE_OK = ("<Rule><ID>r1</ID><Status>Enabled</Status>"
           "<Filter><Prefix>logs/</Prefix></Filter>"
           "<Expiration><Days>30</Days></Expiration></Rule>")
VALIDATE_REJECTS = [
    "<Rule><ID>a</ID><Status>Enabled</Status><Expiration>"
    "<Days>1</Days><Date>2026-01-01T00:00:00Z</Date></Expiration></Rule>",
    "<Rule><ID>a</ID><Status>Enabled</Status>"
    "<Expiration><Days>0</Days></Expiration></Rule>",
    "<Rule><ID>a</ID><Status>Enabled</Status>"
    "<Transition><Days>1</Days></Transition></Rule>",
    "<Rule><ID>a</ID><Status>Enabled</Status>"
    "<Filter><Tag><Key>k</Key><Value>v</Value></Tag></Filter>"
    "<Expiration><ExpiredObjectDeleteMarker>true"
    "</ExpiredObjectDeleteMarker></Expiration></Rule>",
    "<Rule><ID>a</ID><Status>Enabled</Status>"
    "<NoncurrentVersionExpiration><NewerNoncurrentVersions>3"
    "</NewerNoncurrentVersions></NoncurrentVersionExpiration></Rule>",
    "<Rule><ID>a</ID><Status>Enabled</Status>"
    "<Filter><Prefix>x/</Prefix></Filter></Rule>",
]


@pytest.fixture(autouse=True)
def _now(monkeypatch):
    now = time.time_ns() // 10 ** 9 * 10 ** 9
    monkeypatch.setattr(sys.modules[__name__], "T_NOW", now)
    monkeypatch.setattr(sys.modules[__name__], "NOW", now / 1e9)


# --- the rule engine ------------------------------------------------------

def _outcome(fn):
    """fn()'s value, or its error's type name and message."""
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 - the error is the outcome
        return ("error", type(exc).__name__, str(exc))


def _parse(m, body: str, **kw):
    return m.lifecycle.Lifecycle.parse(
        f"<LifecycleConfiguration>{body}</LifecycleConfiguration>", **kw)


def _rules(lc) -> list:
    return [dataclasses.asdict(r) for r in lc.rules] + [len(lc.active)]


def _tags_meta(**tags):
    return {"x-mtpu-internal-tags": urllib.parse.urlencode(
        list(tags.items()))}


def _days_ago(days: float) -> int:
    return int((NOW - days * 86400) * 1e9)


ENGINE = {
    "parse_prefix_filter": lambda m: _rules(_parse(m, RULE_OK)),
    "parse_legacy_toplevel_prefix": lambda m: _rules(_parse(
        m, "<Rule><Status>Enabled</Status><Prefix>old/</Prefix>"
        "<Expiration><Days>1</Days></Expiration></Rule>")),
    "parse_tag_filter": lambda m: _rules(_parse(
        m, "<Rule><Status>Enabled</Status><Filter><Tag><Key>env</Key>"
        "<Value>dev</Value></Tag></Filter><Expiration><Days>1</Days>"
        "</Expiration></Rule>")),
    "parse_and_filter": lambda m: _rules(_parse(
        m, "<Rule><Status>Enabled</Status><Filter><And>"
        "<Prefix>tmp/</Prefix><Tag><Key>a</Key><Value>1</Value></Tag>"
        "<Tag><Key>b</Key><Value>2</Value></Tag></And></Filter>"
        "<Expiration><Days>1</Days></Expiration></Rule>")),
    "parse_rejects_mixed_filter_forms": lambda m: [_outcome(
        lambda b=b: _rules(_parse(m, b))) for b in (
        "<Rule><Status>Enabled</Status><Filter><Prefix>x/</Prefix><Tag>"
        "<Key>k</Key><Value>v</Value></Tag></Filter><Expiration><Days>1"
        "</Days></Expiration></Rule>",
        "<Rule><Status>Enabled</Status><Filter><Prefix>x/</Prefix><And>"
        "<Prefix>y/</Prefix></And></Filter><Expiration><Days>1</Days>"
        "</Expiration></Rule>")],
    "parse_rejects_duplicate_and_tags": lambda m: _outcome(lambda: _rules(
        _parse(m, "<Rule><Status>Enabled</Status><Filter><And><Tag><Key>k"
               "</Key><Value>1</Value></Tag><Tag><Key>k</Key><Value>2"
               "</Value></Tag></And></Filter><Expiration><Days>1</Days>"
               "</Expiration></Rule>"))),
    "parse_date_must_be_midnight_utc": lambda m: [_outcome(
        lambda t=t: _rules(_parse(
            m, f"<Rule><Status>Enabled</Status><Expiration><Date>{t}"
            "</Date></Expiration></Rule>")))
        for t in ("2026-01-01T00:00:00Z", "2026-01-01T13:30:00Z")],
    "disabled_rules_kept_but_inactive": lambda m: [
        _rules(_parse(m, RULE_OK + RULE_OK.replace("Enabled", "Disabled")
                      .replace("r1", "r2"))),
        _outcome(_parse(m, RULE_OK + RULE_OK.replace(
            "Enabled", "Disabled").replace("r1", "r2")).validate),
        _outcome(_parse(m, RULE_OK.replace("Enabled", "Disabled")).validate),
        _parse(m, RULE_OK.replace("Enabled", "Disabled")).expire_current(
            "logs/x", {}, _days_ago(90), NOW)],
    "malformed_xml_raises": lambda m: _outcome(
        lambda: m.lifecycle.Lifecycle.parse("<LifecycleConfiguration><Rule>")),
    "parse_namespaced_document": lambda m: [
        _rules(lc := m.lifecycle.Lifecycle.parse(
            '<LifecycleConfiguration '
            'xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            "<Rule><ID>ns</ID><Status>Enabled</Status>"
            "<Filter><And><Prefix>p/</Prefix>"
            "<Tag><Key>k</Key><Value>v</Value></Tag></And></Filter>"
            "<Expiration><Days>7</Days></Expiration>"
            "<NoncurrentVersionExpiration><NoncurrentDays>3</NoncurrentDays>"
            "</NoncurrentVersionExpiration>"
            "</Rule></LifecycleConfiguration>")),
        _outcome(lc.validate)],
    "non_integer_fields_raise_lifecycle_error": lambda m: _outcome(
        lambda: _parse(m, "<Rule><Status>Enabled</Status><Expiration>"
                       "<Days>abc</Days></Expiration></Rule>")),
    "best_effort_parse_salvages_valid_rules": lambda m: [
        _outcome(lambda: _rules(_parse(m, BAD_THEN_OK))),
        _rules(_parse(m, BAD_THEN_OK, best_effort=True))],
    "validate_rejects_nonpositive_noncurrent": lambda m: _outcome(
        _parse(m, "<Rule><ID>a</ID><Status>Enabled</Status>"
               "<NoncurrentVersionExpiration><NoncurrentDays>-1"
               "</NoncurrentDays></NoncurrentVersionExpiration></Rule>"
               ).validate),
    "validate_duplicate_rule_ids": lambda m: _outcome(
        _parse(m, RULE_OK + RULE_OK).validate),
    "validate_empty": lambda m: _outcome(_parse(m, "").validate),
    "validate_accepts_full_rule_set": lambda m: _outcome(_parse(
        m, "<Rule><ID>a</ID><Status>Enabled</Status>"
        "<Filter><And><Prefix>p/</Prefix>"
        "<Tag><Key>k</Key><Value>v</Value></Tag></And></Filter>"
        "<Expiration><Days>10</Days></Expiration>"
        "<Transition><Days>3</Days><StorageClass>COLD</StorageClass>"
        "</Transition>"
        "<NoncurrentVersionExpiration><NoncurrentDays>5</NoncurrentDays>"
        "<NewerNoncurrentVersions>2</NewerNoncurrentVersions>"
        "</NoncurrentVersionExpiration>"
        "<AbortIncompleteMultipartUpload><DaysAfterInitiation>7"
        "</DaysAfterInitiation></AbortIncompleteMultipartUpload>"
        "</Rule>").validate),
    "expire_days_midnight_truncation": lambda m: [
        _parse(m, "<Rule><Status>Enabled</Status><Expiration><Days>1</Days>"
               "</Expiration></Rule>").expire_current("o", {}, t, NOW)
        for t in (_days_ago(1.5), _days_ago(3), _days_ago(1 / 24))],
    "expire_date_rules": lambda m: [
        _parse(m, "<Rule><Status>Enabled</Status><Expiration><Date>"
               f"{d}</Date></Expiration></Rule>").expire_current(
            "o", {}, t, NOW)
        for d, t in (("2020-01-01T00:00:00Z", T_NOW),
                     ("2199-01-01T00:00:00Z", _days_ago(9)))],
    "expire_tag_filtered": lambda m: [
        _parse(m, "<Rule><Status>Enabled</Status><Filter><Tag><Key>env"
               "</Key><Value>dev</Value></Tag></Filter><Expiration><Date>"
               "2020-01-01T00:00:00Z</Date></Expiration></Rule>"
               ).expire_current("o", meta, _days_ago(9), NOW)
        for meta in (_tags_meta(env="dev"), _tags_meta(env="prod"), {})],
    "expire_and_filter_needs_all": lambda m: [
        _parse(m, "<Rule><Status>Enabled</Status><Filter><And>"
               "<Prefix>tmp/</Prefix><Tag><Key>a</Key><Value>1</Value></Tag>"
               "<Tag><Key>b</Key><Value>2</Value></Tag></And></Filter>"
               "<Expiration><Date>2020-01-01T00:00:00Z</Date></Expiration>"
               "</Rule>").expire_current(name, meta, _days_ago(9), NOW)
        for name, meta in (("tmp/x", _tags_meta(a="1", b="2")),
                           ("tmp/x", _tags_meta(a="1")),
                           ("other/x", _tags_meta(a="1", b="2")))],
    "transition_date_and_tier": lambda m: [
        _parse(m, "<Rule><Status>Enabled</Status><Transition><Date>"
               "2020-01-01T00:00:00Z</Date><StorageClass>GLACIER"
               "</StorageClass></Transition></Rule>").transition_tier_due(
            "o", {}, T_NOW, NOW),
        _parse(m, "<Rule><Status>Enabled</Status><Transition><Days>9000"
               "</Days><StorageClass>GLACIER</StorageClass></Transition>"
               "</Rule>").transition_tier_due("o", {}, T_NOW, NOW)],
    "noncurrent_policy_aggregation": lambda m: [
        _parse(m, NONCURRENT_RULES).noncurrent_policy(k)
        for k in ("a/b/x", "a/zzz", "other")],
    "delete_marker_and_abort_mpu_prefix_scope": lambda m: [
        (lc := _parse(m, MARKER_MPU_RULES)).wants_delete_marker_cleanup(
            "logs/app.log"),
        lc.wants_delete_marker_cleanup("data/app.log"),
        lc.abort_mpu_after_days("up/x/f"), lc.abort_mpu_after_days("up/y"),
        lc.abort_mpu_after_days("elsewhere")],
    "object_tags_decode": lambda m: [
        m.lifecycle.object_tags(_tags_meta(a="1", b="x y")),
        m.lifecycle.object_tags({}), m.lifecycle.object_tags(None)],
    "parse_extended_rules": lambda m: _rules(
        m.scanner.parse_lifecycle(LC_XML)),
}
ENGINE.update({f"validate_rejects_{i}": (
    lambda m, b=b: _outcome(_parse(m, b).validate))
    for i, b in enumerate(VALIDATE_REJECTS)})
BAD_THEN_OK = ("<Rule><ID>bad</ID><Status>Enabled</Status>"
               "<Expiration><Days>oops</Days></Expiration></Rule>" + RULE_OK)
NONCURRENT_RULES = (
    "<Rule><Status>Enabled</Status><Filter><Prefix>a/</Prefix></Filter>"
    "<NoncurrentVersionExpiration><NoncurrentDays>10</NoncurrentDays>"
    "</NoncurrentVersionExpiration></Rule>"
    "<Rule><Status>Enabled</Status><Filter><Prefix>a/b</Prefix></Filter>"
    "<NoncurrentVersionExpiration><NoncurrentDays>4</NoncurrentDays>"
    "<NewerNoncurrentVersions>2</NewerNoncurrentVersions>"
    "</NoncurrentVersionExpiration></Rule>"
    "<Rule><Status>Enabled</Status>"
    "<Filter><Tag><Key>k</Key><Value>v</Value></Tag></Filter>"
    "<NoncurrentVersionExpiration><NoncurrentDays>1</NoncurrentDays>"
    "</NoncurrentVersionExpiration></Rule>")
MARKER_MPU_RULES = (
    "<Rule><Status>Enabled</Status><Filter><Prefix>logs/</Prefix>"
    "</Filter><Expiration><ExpiredObjectDeleteMarker>true"
    "</ExpiredObjectDeleteMarker></Expiration></Rule>"
    "<Rule><Status>Enabled</Status><Filter><Prefix>up/</Prefix>"
    "</Filter><AbortIncompleteMultipartUpload><DaysAfterInitiation>5"
    "</DaysAfterInitiation></AbortIncompleteMultipartUpload></Rule>"
    "<Rule><Status>Enabled</Status><Filter><Prefix>up/x/</Prefix>"
    "</Filter><AbortIncompleteMultipartUpload><DaysAfterInitiation>2"
    "</DaysAfterInitiation></AbortIncompleteMultipartUpload></Rule>")


@pytest.mark.parametrize("name", sorted(ENGINE))
def test_engine_case_on_both_packages(name):
    port = _outcome(lambda: ENGINE[name](MODS[PORT]))
    jax = _outcome(lambda: ENGINE[name](MODS[JAX]))
    assert port == jax
    assert port[0] == "ok"  # a case's errors are inside its value


# --- the scanner ------------------------------------------------------------

@pytest.fixture
def env(monkeypatch):
    """Both packages at 12 KiB erasure blocks and a 1 KiB inline
    threshold, minio_tpu with dense-gf8 and no worker pool."""
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "1024")
    monkeypatch.setattr(jax_eo, "BLOCK_SIZE_V2", SMALL_BLOCK)
    monkeypatch.setattr(erasure_objects, "BLOCK_SIZE_V2", SMALL_BLOCK)
    return monkeypatch


class Stack(types.SimpleNamespace):
    """One package's object layer, bucket metadata, metrics and scanner
    over 4 drives, and the helpers of the cases."""

    def bucket(self, name: str, lifecycle_xml: str = "",
               versioned: bool = False, **fields) -> None:
        self.ol.make_bucket(name)
        if versioned:
            self.bm.update(name, "versioning_xml", VERSIONED)
        if lifecycle_xml:
            self.bm.update(name, "lifecycle_xml", lifecycle_xml)
        for k, v in fields.items():
            self.bm.update(name, k, v)

    def put(self, bucket: str, key: str, body: bytes, age_days: float = 0,
            versioned: bool = True, **meta):
        self.clock.now += 10 ** 9
        opts = self.m.Options(versioned=versioned, user_defined=dict(meta))
        if age_days:
            opts.mod_time_ns = T_NOW - int(age_days * DAY_NS)
        return self.ol.put_object(bucket, key, io.BytesIO(body), len(body),
                                  opts)

    def versions(self, bucket: str, key: str) -> list:
        res = self.ol.list_object_versions(bucket, prefix=key, max_keys=50)
        return [(v.version_id, v.is_latest, v.delete_marker, v.mod_time_ns)
                for v in res.versions if v.name == key]

    def names(self, bucket: str) -> list:
        return sorted(o.name for o in self.ol.list_objects(
            bucket, max_keys=100).objects)

    def expired(self) -> float:
        return self.metrics.counter_value("ilm_expired_total")


def _stack(pkg: str, root, mp) -> Stack:
    m = MODS[pkg]
    clock = _alike(mp)
    clock.now = T_NOW
    for mod in (scanner, jax_scanner):
        mp.setattr(mod, "time", _Shim(time, time_ns=clock.time_ns))
    disks = [m.Local(str(root / f"d{i}"), endpoint=f"d{i}", **m.kw)
             for i in range(4)]
    sets = m.Sets(disks, 4, deployment_id=DEP, pool_index=0, **m.kw)
    sets.init_format()
    ol = m.Pools([sets], **m.kw)
    bm = m.BM(ol)
    metrics = m.Metrics()
    return Stack(m=m, ol=ol, bm=bm, clock=clock, metrics=metrics, root=root,
                 scanner=m.scanner.DataScanner(ol, bm, metrics=metrics))


def scan_noncurrent_age_counts_from_successor(s):
    s.bucket("lcb", LC_XML, versioned=True)
    s.put("lcb", "doc", b"old1", age_days=30)
    s.put("lcb", "doc", b"old2", age_days=10)
    s.put("lcb", "doc", b"current")
    s.scanner.scan_cycle()
    sink = io.BytesIO()
    s.ol.get_object("lcb", "doc", sink)
    return s.versions("lcb", "doc"), sink.getvalue()


def scan_fresh_noncurrent_versions_survive(s):
    s.bucket("lcb", LC_XML, versioned=True)
    s.put("lcb", "fresh", b"old", age_days=2)
    s.put("lcb", "fresh", b"new", age_days=2)
    s.scanner.scan_cycle()
    return s.versions("lcb", "fresh")


def scan_orphan_delete_marker_removed(s):
    s.bucket("lcb", LC_XML, versioned=True)
    s.put("lcb", "ghost", b"x", age_days=30)
    s.ol.delete_object("lcb", "ghost", s.m.Options(
        versioned=True, mod_time_ns=T_NOW - 20 * DAY_NS))
    s.scanner.scan_cycle()
    first = s.versions("lcb", "ghost")
    s.scanner.scan_cycle()
    return first, s.versions("lcb", "ghost")


def scan_stale_multipart_aborted(s):
    s.bucket("lcb", LC_XML, versioned=True)
    es = s.ol.pools[0].sets[0]
    es.new_multipart_upload("lcb", "big.bin")
    before = len(es.list_multipart_uploads_all())
    rules = s.m.scanner.parse_lifecycle(LC_XML)
    s.scanner._cycle_uploads = None
    s.scanner._abort_stale_uploads("lcb", rules, T_NOW + 4 * DAY_NS)
    aborted = es.list_multipart_uploads_all()
    s.clock.now += 10 ** 9
    es.new_multipart_upload("lcb", "fresh.bin")
    s.scanner._cycle_uploads = None
    s.scanner._abort_stale_uploads("lcb", rules, T_NOW)
    return before, aborted, [u for u, _ in es.list_multipart_uploads_all()]


def scan_tag_filtered_expiry(s):
    s.bucket("tagbkt", "<LifecycleConfiguration><Rule><ID>dev-only</ID>"
             "<Status>Enabled</Status><Filter><Tag><Key>env</Key>"
             "<Value>dev</Value></Tag></Filter><Expiration><Date>"
             "2020-01-01T00:00:00Z</Date></Expiration></Rule>"
             "</LifecycleConfiguration>")
    tags = "x-mtpu-internal-tags"
    s.put("tagbkt", "dev.bin", b"d", versioned=False, **{tags: "env=dev"})
    s.put("tagbkt", "prod.bin", b"p", versioned=False, **{tags: "env=prod"})
    s.put("tagbkt", "untagged.bin", b"u", versioned=False)
    s.scanner.scan_cycle()
    return s.names("tagbkt")


def scan_newer_noncurrent_versions_retention(s):
    s.bucket("nnv", "<LifecycleConfiguration><Rule><ID>nnv</ID>"
             "<Status>Enabled</Status><Filter><Prefix></Prefix></Filter>"
             "<NoncurrentVersionExpiration><NoncurrentDays>1"
             "</NoncurrentDays><NewerNoncurrentVersions>2"
             "</NewerNoncurrentVersions></NoncurrentVersionExpiration>"
             "</Rule></LifecycleConfiguration>", versioned=True)
    for age in (10, 9, 8, 7, 6, 0):
        s.put("nnv", "doc", b"v%02d" % age, age_days=age)
    s.scanner.scan_cycle()
    return s.versions("nnv", "doc")


def scan_unversioned_expiry_by_prefix(s):
    """Phase 4o's unversioned bucket at 4 drives: Expiration Days=1 on
    logs/, an old logs/ object and keep/ object, and a stale upload,
    swept two days ahead, then a real cycle."""
    s.bucket("ilm", "<LifecycleConfiguration><Rule><ID>logs</ID><Status>"
             "Enabled</Status><Filter><Prefix>logs/</Prefix></Filter>"
             "<Expiration><Days>1</Days></Expiration></Rule><Rule><ID>mpu"
             "</ID><Status>Enabled</Status><Filter><Prefix></Prefix>"
             "</Filter><AbortIncompleteMultipartUpload><DaysAfterInitiation>"
             "1</DaysAfterInitiation></AbortIncompleteMultipartUpload></Rule>"
             "</LifecycleConfiguration>")
    s.put("ilm", "logs/a.log", b"L" * 5000, versioned=False)
    s.put("ilm", "keep/b.bin", b"K" * 5000, versioned=False)
    s.ol.pools[0].sets[0].new_multipart_upload("ilm", "logs/open.bin")
    ahead = T_NOW + 2 * DAY_NS
    rules = s.m.scanner.parse_lifecycle(s.bm.get("ilm").lifecycle_xml)
    swept = [s.scanner._apply_lifecycle("ilm", oi, rules, ahead)
             for oi in s.ol.list_objects("ilm", max_keys=10).objects]
    s.scanner._abort_stale_uploads("ilm", rules, ahead)
    usage = s.scanner.scan_cycle()
    return (swept, s.names("ilm"), s.expired(),
            usage.buckets_usage["ilm"].objects_size,
            s.ol.pools[0].sets[0].list_multipart_uploads_all())


SCANS = {name[len("scan_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("scan_")}


@pytest.mark.parametrize("name", sorted(SCANS))
def test_scanner_case_on_both_packages(env, tmp_path, name):
    seen = {}
    for pkg in (JAX, PORT):
        with pytest.MonkeyPatch.context() as mp:
            s = _stack(pkg, tmp_path / pkg, mp)
            seen[pkg] = (SCANS[name](s), s.expired(), _tree(s.root))
    assert seen[PORT][:2] == seen[JAX][:2]
    jax, port = seen[JAX][2], seen[PORT][2]
    assert port.keys() == jax.keys()
    assert [k for k in jax if port[k] != jax[k]] == []


# --- where minio_tpu is at fault ---------------------------------------------

RETAINED_LC = ("<LifecycleConfiguration><Rule><ID>nc</ID><Status>Enabled"
               "</Status><Filter><Prefix></Prefix></Filter>"
               "<NoncurrentVersionExpiration><NoncurrentDays>1"
               "</NoncurrentDays></NoncurrentVersionExpiration></Rule>"
               "</LifecycleConfiguration>")


def test_noncurrent_expiry_keeps_retained_versions(env, tmp_path):
    """Three noncurrent versions a day past NoncurrentDays: one under
    COMPLIANCE retention until tomorrow, one under legal hold, one free.
    minio_tpu deletes all three; MinIO (evalActionFromLifecycle) and the
    port delete only the free one."""
    out = {}
    until = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                          time.gmtime(NOW + 86400))
    for pkg in (JAX, PORT):
        with pytest.MonkeyPatch.context() as mp:
            s = _stack(pkg, tmp_path / pkg, mp)
            s.bucket("worm", RETAINED_LC, versioned=True)
            s.put("worm", "doc", b"retained", age_days=4, **{
                "x-amz-object-lock-mode": "COMPLIANCE",
                "x-amz-object-lock-retain-until-date": until})
            s.put("worm", "doc", b"held", age_days=3,
                  **{"x-amz-object-lock-legal-hold": "ON"})
            s.put("worm", "doc", b"free", age_days=2.5)
            s.put("worm", "doc", b"current", age_days=2)
            s.scanner._versions_sweep("worm", s.m.scanner.parse_lifecycle(
                RETAINED_LC), T_NOW)
            left = [b for vid, *_ in s.versions("worm", "doc")
                    for b in [s.ol.get_object_bytes(
                        "worm", "doc", opts=s.m.Options(version_id=vid))]]
            out[pkg] = (left, s.expired())
    assert out[JAX] == ([b"current"], 3)
    assert out[PORT] == ([b"current", b"held", b"retained"], 1)


def test_versioned_expiry_writes_a_delete_marker(env, tmp_path):
    """An Expiration Days=1 rule in a versioned bucket, swept two days
    ahead: minio_tpu's expiry finds no version ("" is not the current
    version's id) and nothing expires; MinIO and the port write a delete
    marker, the version kept beneath it."""
    out = {}
    lc = ("<LifecycleConfiguration><Rule><ID>e</ID><Status>Enabled</Status>"
          "<Filter><Prefix></Prefix></Filter><Expiration><Days>1</Days>"
          "</Expiration></Rule></LifecycleConfiguration>")
    for pkg in (JAX, PORT):
        with pytest.MonkeyPatch.context() as mp:
            s = _stack(pkg, tmp_path / pkg, mp)
            s.bucket("vexp", lc, versioned=True)
            s.put("vexp", "k", b"abc")
            rules = s.m.scanner.parse_lifecycle(lc)
            (oi,) = s.ol.list_objects("vexp", max_keys=10).objects
            s.clock.now += 10 ** 9  # the marker's time
            swept = s.scanner._apply_lifecycle("vexp", oi, rules,
                                               T_NOW + 2 * DAY_NS)
            out[pkg] = (swept, [(latest, marker) for _, latest, marker, _
                                in s.versions("vexp", "k")],
                        s.names("vexp"), s.expired())
    assert out[JAX] == (False, [(True, False)], ["k"], 0)
    assert out[PORT] == (True, [(True, True), (False, False)], [], 1)

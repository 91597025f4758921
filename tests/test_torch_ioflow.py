"""The port's byte-flow ledger (minio_tpu_torch/observability/ioflow.py)
against minio_tpu's, on the CPU.

Each case of tests/test_ioflow.py but the storage-REST one (the port has
no distributed planes) and the end-to-end one runs on both packages
(`pkg`): attribution to the current op, nested tags, the degraded-GET
retag across threads and its limit to GETs, the MTPU_IOFLOW switch, the
efficiency ratios and their empty sides, the space-saving sketch, the
hot-bucket feed, the per-thread sums and the report's shape.

Then a PUT, a degraded GET (the object lost on drives 0, 5, 12 and 15)
and a HealObject through both packages' object layers (one 12+4 set on
16 drives, BLOCK_SIZE_V2 = 12 * 4096, an object of 10 blocks and a
tail, ids and clocks made alike): the snapshots' bytes must agree
exactly by op class, drive and direction, and the logical bytes by op
class, step by step. minio_tpu runs with MTPU_WORKER_POOL=0 and
MTPU_CODEC=dense-gf8.

Last, the drives under the health wrapper on a multi-core host, where
each op runs on its drive's own pool thread: the port carries the op tag
into that thread, so no byte of a tagged PUT counts as untagged.
minio_tpu's wrapper does not carry it (ROADMAP Queue 3); the case holds
both packages to what each does.
"""

import io
import random
import shutil
import threading
import uuid

import numpy as np
import pytest
import torch

import minio_tpu.erasure.streaming as jax_streaming
import minio_tpu.object.erasure_objects as jax_eo
import minio_tpu.object.multipart as jax_mp
import minio_tpu.storage.diskcheck as jax_diskcheck
from minio_tpu.object import readtier as jax_readtier
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.object.types import ObjectOptions as JaxObjectOptions
from minio_tpu.observability import ioflow as jax_ioflow
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu_torch.object import erasure_objects
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.object.types import ObjectOptions
from minio_tpu_torch.observability import ioflow
from minio_tpu_torch.storage.diskcheck import DiskHealth, MetricsDisk
from minio_tpu_torch.storage.local import LocalStorage
from minio_tpu_torch.utils import fanout

torch.set_num_threads(1)

PORT, JAX = "port", "jax"
IOFLOW = {PORT: ioflow, JAX: jax_ioflow}
BUCKET, NAME = "bkt", "dir/obj.bin"
BLOCK = 12 * 4096
SIZE = 10 * BLOCK + 12_345
MOD_TIME = 1_700_000_000_123_456_789
LOST = (0, 5, 12, 15)


@pytest.fixture(autouse=True)
def _fresh_ledgers():
    """Both ledgers from zero, and after each case both ledgers and
    minio_tpu's read tier (which a hot bucket in its ledger arms) back
    to their start, so no case leaks into a later one."""
    for io_ in IOFLOW.values():
        io_.reset()
    yield
    for io_ in IOFLOW.values():
        io_.reset()
    jax_readtier.reset()


@pytest.fixture(params=[JAX, PORT])
def io_(request):
    return IOFLOW[request.param]


# --- op-tag mechanics ------------------------------------------------------

def test_account_attributes_to_current_op(io_):
    with io_.tag("put", bucket="b"):
        io_.account("d0", "write", 100)
        io_.account("d0", "write", 50)
        io_.account("d1", "wmeta", 7)
    io_.account("d0", "write", 9)  # outside any tag
    snap = io_.snapshot()
    assert snap["bytes"][("d0", "put", "write")] == 150
    assert snap["bytes"][("d1", "put", "wmeta")] == 7
    assert snap["bytes"][("d0", "untagged", "write")] == 9


def test_nested_tags_shadow_and_restore(io_):
    with io_.tag("scan"):
        io_.account("d0", "rmeta", 1)
        with io_.tag("heal"):
            io_.account("d0", "read", 2)
        io_.account("d0", "rmeta", 4)
    b = io_.snapshot()["bytes"]
    assert b[("d0", "scan", "rmeta")] == 5
    assert b[("d0", "heal", "read")] == 2


def test_retag_degraded_reclassifies_shared_holder_across_threads(io_):
    with io_.tag("get", bucket="b"):
        io_.account("d0", "read", 10)
        carrier = io_.capture()

        def reader():
            with io_.activate(carrier):
                io_.retag_degraded()
                io_.account("d1", "read", 20)

        t = threading.Thread(target=reader)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        io_.account("d0", "read", 30)  # after the other thread's retag
    b = io_.snapshot()["bytes"]
    assert b[("d0", "get", "read")] == 10
    assert b[("d1", "get-degraded", "read")] == 20
    assert b[("d0", "get-degraded", "read")] == 30


def test_retag_degraded_only_promotes_get(io_):
    with io_.tag("heal"):
        io_.retag_degraded()  # a heal sees missing shards by design
        io_.account("d0", "read", 5)
    assert ("d0", "heal", "read") in io_.snapshot()["bytes"]


def test_knob_disarms_ledger(io_, monkeypatch):
    monkeypatch.setenv("MTPU_IOFLOW", "0")
    with io_.tag("put", bucket="b"):
        io_.account("d0", "write", 100)
        io_.logical(100)
    assert io_.snapshot() == {"bytes": {}, "logical": {}, "served": {}}
    monkeypatch.setenv("MTPU_IOFLOW", "1")
    with io_.tag("put", bucket="b"):
        io_.account("d0", "write", 1)
    assert io_.snapshot()["bytes"] == {("d0", "put", "write"): 1}


def test_efficiency_ratios(io_):
    with io_.tag("heal"):
        io_.account("d0", "read", 1200)
        io_.account("d1", "write", 100)
    with io_.tag("get", bucket="b"):
        io_.retag_degraded()
        io_.account("d0", "read", 220)
        io_.logical(200)
    with io_.tag("scan"):
        io_.account("d0", "rmeta", 50)
    eff = io_.efficiency(scan_objects=10)
    assert eff["heal_bytes_read_per_byte_healed"] == 12.0
    assert eff["degraded_get_read_amplification"] == 1.1
    assert eff["scan_bytes_per_object"] == 5.0


def test_efficiency_empty_sides_are_none_not_zero(io_):
    eff = io_.efficiency(scan_objects=0)
    assert eff["heal_bytes_read_per_byte_healed"] is None
    assert eff["degraded_get_read_amplification"] is None
    assert eff["scan_bytes_per_object"] is None


# --- space-saving sketch ---------------------------------------------------

def test_space_saving_exact_under_capacity(io_):
    sk = io_.SpaceSaving(4)
    for key, w in (("a", 10), ("b", 5), ("a", 3)):
        sk.offer(key, w)
    top = sk.top()
    assert top[0] == {"bucket": "a", "bytes": 13, "overcount": 0}
    assert top[1] == {"bucket": "b", "bytes": 5, "overcount": 0}


def test_space_saving_eviction_bounds_error(io_):
    sk = io_.SpaceSaving(2)
    sk.offer("heavy", 1000)
    sk.offer("light", 1)
    sk.offer("new", 5)  # evicts light (min=1), inherits its count
    top = {e["bucket"]: e for e in sk.top()}
    assert "light" not in top
    assert top["heavy"]["bytes"] == 1000
    assert top["new"]["bytes"] == 6
    assert top["new"]["overcount"] == 1
    for i in range(100):
        sk.offer(f"k{i}", 1)
    assert "heavy" in {e["bucket"] for e in sk.top()}


def test_hot_bucket_feed_flushes_on_context_exit(io_):
    with io_.tag("put", bucket="hot-bkt"):
        io_.account("d0", "write", 4096)
        io_.account("d0", "wmeta", 99)  # metadata: not sketch-fed
    assert io_.hot_buckets() == [
        {"bucket": "hot-bkt", "bytes": 4096, "overcount": 0}]


# --- cross-thread aggregation ----------------------------------------------

def test_snapshot_sums_across_threads(io_):
    with io_.tag("put", bucket="b"):
        carrier = io_.capture()

        def work():
            with io_.activate(carrier):
                for _ in range(100):
                    io_.account("d0", "write", 3)

        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        io_.account("d0", "write", 1)
    assert io_.snapshot()["bytes"][("d0", "put", "write")] == 1201


def test_report_shape(io_):
    with io_.tag("put", bucket="b"):
        io_.account("d0", "write", 10)
    rep = io_.report(scan_objects=0)
    assert rep["bytes"]["put"]["d0"]["write"] == 10
    assert rep["opTotals"]["put"]["write"] == 10
    assert set(rep["efficiency"]) == {
        "heal_bytes_read_per_byte_healed",
        "repair_wire_bytes_per_byte_healed",
        "degraded_get_read_amplification",
        "scan_bytes_per_object",
    }
    assert rep["hotBuckets"][0]["bucket"] == "b"


def test_descriptors_and_op_classes_are_minio_tpus():
    assert ioflow.IOFLOW_DESCRIPTORS == jax_ioflow.IOFLOW_DESCRIPTORS
    assert ioflow.OP_CLASSES == jax_ioflow.OP_CLASSES


# --- PUT, degraded GET and heal through both object layers -----------------

def _set(pkg: str, root, wrapped: bool = False):
    if pkg == PORT:
        disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}",
                              device="cpu") for i in range(16)]
        if wrapped:
            disks = [MetricsDisk(d, None, health=DiskHealth(f"d{i}"))
                     for i, d in enumerate(disks)]
        sets = ErasureSets(disks, 16, default_parity=4, device="cpu")
    else:
        disks = [JaxLocalStorage(str(root / f"d{i}"), endpoint=f"d{i}")
                 for i in range(16)]
        if wrapped:
            disks = [jax_diskcheck.MetricsDisk(
                d, None, health=jax_diskcheck.DiskHealth(f"d{i}"))
                for i, d in enumerate(disks)]
        sets = JaxErasureSets(disks, 16, default_parity=4)
    sets.init_format()
    sets.make_bucket(BUCKET)
    return sets


def _delta(before: dict, after: dict) -> dict:
    out = {}
    for part in ("bytes", "logical"):
        diff = {k: v - before[part].get(k, 0)
                for k, v in after[part].items()}
        out[part] = {k: v for k, v in diff.items() if v}
    return out


def _put_get_heal(pkg: str, root) -> dict:
    """The ledger's deltas of each step."""
    io_ = IOFLOW[pkg]
    payload = np.random.default_rng(21).bytes(SIZE)
    opts = (ObjectOptions if pkg == PORT else JaxObjectOptions)(
        mod_time_ns=MOD_TIME)
    sets = _set(pkg, root)
    steps = {}
    snap = io_.snapshot()
    with io_.tag("put", bucket=BUCKET):
        sets.put_object(BUCKET, NAME, io.BytesIO(payload), SIZE, opts)
    steps["put"], snap = _delta(snap, io_.snapshot()), io_.snapshot()
    for i in LOST:
        shutil.rmtree(root / f"d{i}" / BUCKET / "dir")
    sink = io.BytesIO()
    with io_.tag("get", bucket=BUCKET):
        sets.get_object(BUCKET, NAME, sink)
    assert sink.getvalue() == payload
    steps["get"], snap = _delta(snap, io_.snapshot()), io_.snapshot()
    sets.heal_object(BUCKET, NAME)
    steps["heal"] = _delta(snap, io_.snapshot())
    return steps


@pytest.mark.parametrize("single_core", [True, False],
                         ids=["serial", "pipelined"])
def test_put_degraded_get_heal_bytes_equal(tmp_path, monkeypatch,
                                           single_core):
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "4096")
    monkeypatch.setattr(erasure_objects, "BLOCK_SIZE_V2", BLOCK)
    monkeypatch.setattr(jax_eo, "BLOCK_SIZE_V2", BLOCK)
    monkeypatch.setattr(fanout, "SINGLE_CORE", single_core)
    for mod in (jax_streaming, jax_eo, jax_mp):
        monkeypatch.setattr(mod, "_SINGLE_CORE", single_core)
    steps = {}
    for pkg in (JAX, PORT):
        rng = random.Random(5)
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(
            int=rng.getrandbits(128), version=4))
        steps[pkg] = _put_get_heal(pkg, tmp_path / pkg)
    assert steps[PORT] == steps[JAX]
    port = steps[PORT]
    # The step's own op classes, and the degraded GET's shard reads all
    # under get-degraded (a data shard was known lost from the metadata).
    assert {op for _, op, _ in port["put"]["bytes"]} == {"put"}
    assert {op for _, op, _ in port["heal"]["bytes"]} == {"heal"}
    assert not any(op == "get" and d == "read"
                   for _, op, d in port["get"]["bytes"])
    assert port["get"]["logical"] == {"get-degraded": SIZE}
    assert port["put"]["logical"] == {"put": SIZE}
    healed = {drive for drive, _, d in port["heal"]["bytes"]
              if d == "write"}
    assert healed == {f"d{i}" for i in LOST}


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_per_drive_pool_carries_the_op_tag(tmp_path, monkeypatch, pkg):
    """Guarded drives on a multi-core host run each op on the drive's
    own pool thread. The port's pool threads take over the caller's op
    tag; minio_tpu's do not, so its wmeta of the commit (rename_data
    runs on the pool thread) counts as untagged."""
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "4096")
    monkeypatch.setattr(erasure_objects, "BLOCK_SIZE_V2", BLOCK)
    monkeypatch.setattr(jax_eo, "BLOCK_SIZE_V2", BLOCK)
    monkeypatch.setattr(fanout, "SINGLE_CORE", False)
    for mod in (jax_streaming, jax_eo, jax_mp, jax_diskcheck):
        monkeypatch.setattr(mod, "_SINGLE_CORE", False)
    io_ = IOFLOW[pkg]
    sets = _set(pkg, tmp_path, wrapped=True)
    payload = np.random.default_rng(22).bytes(SIZE)
    io_.reset()
    with io_.tag("put", bucket=BUCKET):
        sets.put_object(BUCKET, NAME, io.BytesIO(payload), SIZE)
    ops = {op for _, op, _ in io_.snapshot()["bytes"]}
    assert "put" in ops
    assert ("untagged" in ops) == (pkg == JAX), ops

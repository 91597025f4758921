"""The port's repair plane (erasure/repair.py, read_repair_symbol) against
minio_tpu's, on the CPU.

Shard files are encoded under msr-pm and framed as a PUT frames them
(HighwayHash256S digests between the chunks), two full blocks and a
ragged last one, one drive directory a shard. Both packages' repair_part
then rebuild each target from the same files: the port's output must
equal minio_tpu's and the original file, byte for byte. Blocks are small
(a few KiB): the port's plain HighwayHash is a Python loop.
"""

import io
import shutil

import numpy as np
import pytest
import torch

from minio_tpu.erasure import repair as jax_repair
from minio_tpu.erasure.bitrot import (
    StreamingBitrotWriter as JaxStreamingBitrotWriter,
)
from minio_tpu.erasure.codec import Erasure as JaxErasure
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu_torch.erasure import device_engine, registry, repair
from minio_tpu_torch.erasure.bitrot import DIGEST_SIZE, StreamingBitrotWriter
from minio_tpu_torch.erasure.codec import Erasure
from minio_tpu_torch.object import erasure_objects
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.object.types import ObjectOptions
from minio_tpu_torch.ops import regen
from minio_tpu_torch.storage.local import LocalStorage
from minio_tpu_torch.utils.errors import (
    ErrDiskNotFound,
    ErrFileCorrupt,
    ErrFileNotFound,
)

torch.set_num_threads(1)

VOL, PATH = "vol", "obj/part.1"


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.delenv("MTPU_REPAIR", raising=False)
    repair.reset_stats()


def _framed(tmp_path, k, m, block_size, size):
    """Shard files of a `size`-byte part under msr-pm at k+m: drive i
    holds shard i at VOL/PATH. Returns (port Erasure, drive roots, the
    shard files' bytes)."""
    erasure = Erasure(k, m, block_size, registry.MSR_PM, device="cpu")
    data = np.random.default_rng(size).bytes(size)
    sinks = [io.BytesIO() for _ in range(k + m)]
    writers = [StreamingBitrotWriter(s, device="cpu") for s in sinks]
    for off in range(0, size, block_size):
        for w, shard in zip(writers, erasure.encode_data(
                data[off:off + block_size])):
            w.write(shard)
    roots = []
    for i, sink in enumerate(sinks):
        root = tmp_path / f"d{i}"
        (root / VOL / "obj").mkdir(parents=True)
        (root / VOL / PATH).write_bytes(sink.getvalue())
        roots.append(root)
    return erasure, roots, [s.getvalue() for s in sinks]


def _repair_both(erasure, roots, target, size):
    """(port output, minio_tpu output) of one repair of `target`."""
    k, m = erasure.data_blocks, erasure.parity_blocks
    out = io.BytesIO()
    sources = [None if i == target else repair.SymbolSource(
        LocalStorage(str(r), device="cpu"), VOL, PATH, DIGEST_SIZE)
        for i, r in enumerate(roots)]
    repair.repair_part(erasure, target, sources,
                       StreamingBitrotWriter(out, device="cpu"), size)
    jax_out = io.BytesIO()
    jax_sources = [None if i == target else jax_repair.SymbolSource(
        JaxLocalStorage(str(r)), VOL, PATH, DIGEST_SIZE)
        for i, r in enumerate(roots)]
    jax_repair.repair_part(JaxErasure(k, m, erasure.block_size, "msr-pm"),
                           target, jax_sources,
                           JaxStreamingBitrotWriter(jax_out), size)
    return out.getvalue(), jax_out.getvalue()


@pytest.mark.parametrize("k,m,block_size,size", [
    (4, 4, 4096, 2 * 4096 + 777),    # coupled-layer, alpha 16
    (6, 3, 4096, 2 * 4096 + 100),    # coupled-layer, alpha 27
    (12, 4, 12 * 512, 2 * 12 * 512 + 1235),  # piggyback, alpha 2
])
def test_repair_part_is_minio_tpus(tmp_path, k, m, block_size, size):
    erasure, roots, files = _framed(tmp_path, k, m, block_size, size)
    targets = [t for t in range(k + m)
               if repair.plan_for(erasure, t) is not None]
    # Piggyback plans cover the data shards only.
    assert targets == list(range(
        k if regen.arm(k, m) == "piggyback" else k + m))
    for target in targets:
        before = repair.stats_snapshot()
        ours, theirs = _repair_both(erasure, roots, target, size)
        assert ours == theirs == files[target], f"shard {target}"
        after = repair.stats_snapshot()
        plan = repair.plan_for(erasure, target)
        written = after["bytes_written"] - before["bytes_written"]
        assert written == erasure.shard_file_size(size)
        assert (after["bytes_read"] - before["bytes_read"]) * plan.alpha \
            == written * plan.total_symbols


def test_read_repair_symbol_is_minio_tpus(tmp_path):
    blob = np.random.default_rng(5).bytes(3 * (32 + 4096))
    (tmp_path / VOL / "obj").mkdir(parents=True)
    (tmp_path / VOL / PATH).write_bytes(blob[: 2 * (32 + 4096) + 32 + 1600])
    ours = LocalStorage(str(tmp_path), device="cpu")
    theirs = JaxLocalStorage(str(tmp_path))
    for subs, blocks in (([0, 3], [(0, 4096), (1, 4096)]),
                         ([1, 2, 3], [(2, 1600)]), ([2], [(1, 4096)])):
        kw = dict(stride=32 + 4096, digest_size=32, alpha=4, subs=subs,
                  blocks=blocks)
        got = ours.read_repair_symbol(VOL, PATH, **kw)
        assert got == theirs.read_repair_symbol(VOL, PATH, **kw)
        assert len(got) == sum(ln // 4 * len(subs) for _, ln in blocks)
    kw = dict(stride=32 + 4096, digest_size=32, alpha=4, subs=[3],
              blocks=[(2, 4096)])  # past the end of the file
    with pytest.raises(ErrFileCorrupt):
        ours.read_repair_symbol(VOL, PATH, **kw)
    with pytest.raises(ErrFileNotFound):
        ours.read_repair_symbol(VOL, "obj/part.2", **kw)
    with pytest.raises(ValueError):
        ours.read_repair_symbol(VOL, PATH, stride=32 + 4096, digest_size=32,
                                alpha=3, subs=[0], blocks=[(0, 4096)])


def test_repair_part_refuses_what_it_cannot_serve(tmp_path, monkeypatch):
    erasure, roots, _ = _framed(tmp_path, 12, 4, 12 * 512, 12 * 512)
    sources = [repair.SymbolSource(LocalStorage(str(r), device="cpu"), VOL,
                                   PATH, DIGEST_SIZE) for r in roots]
    sink = StreamingBitrotWriter(io.BytesIO(), device="cpu")
    cases = [("no_plan", 13, sources),  # a piggyback parity shard
             ("helper_missing", 0, [None] * 16)]
    for reason, target, srcs in cases:
        with pytest.raises(repair.RepairUnavailable) as exc:
            repair.repair_part(erasure, target, srcs, sink, 12 * 512)
        assert exc.value.reason == reason
    monkeypatch.setenv("MTPU_REPAIR", "0")
    with pytest.raises(repair.RepairUnavailable) as exc:
        repair.repair_part(erasure, 0, sources, sink, 12 * 512)
    assert exc.value.reason == "disabled"
    dense = Erasure(12, 4, 12 * 512, registry.DENSE_GF8, device="cpu")
    assert repair.plan_for(dense, 0) is None


# --- the heal's repair branch and its fallbacks ------------------------

BLOCK = 4 * 1024
SIZE = 3 * BLOCK + 333


@pytest.fixture
def msr_object(tmp_path, monkeypatch):
    """A 4+4 msr-pm object on 8 drive directories (the port's object
    layer), its shard files' bytes, and a function that loses the drive
    of one shard and heals."""
    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "1024")
    monkeypatch.setattr(erasure_objects, "BLOCK_SIZE_V2", BLOCK)
    disks = [LocalStorage(str(tmp_path / f"d{i}"), endpoint=f"d{i}",
                          device="cpu") for i in range(8)]
    sets = ErasureSets(disks, 8, default_parity=4, device="cpu")
    sets.init_format()
    sets.make_bucket("b")
    payload = np.random.default_rng(1).bytes(SIZE)
    sets.put_object("b", "o", io.BytesIO(payload), SIZE,
                    ObjectOptions(codec="msr-pm"))
    fi = disks[0].read_version("b", "o")
    drive = {d - 1: i for i, d in enumerate(fi.erasure.distribution)}

    def files():
        return {i: (tmp_path / f"d{i}" / "b" / "o" / fi.data_dir /
                    "part.1").read_bytes() for i in range(8)}

    original = files()

    def lose_and_heal(shard):
        shutil.rmtree(tmp_path / f"d{drive[shard]}" / "b" / "o")
        return sets.heal_object("b", "o")

    return lose_and_heal, original, files, drive


def test_heal_of_one_shard_goes_through_the_plane(msr_object):
    lose_and_heal, original, files, drive = msr_object
    assert lose_and_heal(2) == {"healed": [f"d{drive[2]}"],
                                "dangling": False}
    assert files() == original
    s = repair.stats_snapshot()
    assert s["parts_repaired"] == 1 and s["fallbacks"] == 0
    assert s["bytes_read"] == 7 * s["bytes_written"] // 4  # 1.75


@pytest.mark.parametrize("reason", ["short_read", "drive_error"])
def test_heal_falls_back_to_dense(msr_object, monkeypatch, reason):
    lose_and_heal, original, files, drive = msr_object
    real = LocalStorage.read_repair_symbol

    def broken(self, *args, **kw):
        if reason == "drive_error":
            raise ErrDiskNotFound(self.endpoint())
        return real(self, *args, **kw)[1:]

    monkeypatch.setattr(LocalStorage, "read_repair_symbol", broken)
    before = device_engine.stats_snapshot()["launches_gf"]
    assert lose_and_heal(5) == {"healed": [f"d{drive[5]}"],
                                "dangling": False}
    assert files() == original
    s = repair.stats_snapshot()
    assert s["parts_repaired"] == 0
    assert s["fallbacks"] == s[f"fallback_{reason}"] == 1
    assert device_engine.stats_snapshot()["launches_gf"] > before


def test_disabled_plane_heals_densely(msr_object, monkeypatch):
    lose_and_heal, original, files, _ = msr_object
    monkeypatch.setenv("MTPU_REPAIR", "0")
    lose_and_heal(0)
    assert files() == original
    assert repair.stats_snapshot()["parts_repaired"] == 0


def test_two_lost_shards_heal_densely(msr_object, tmp_path):
    lose_and_heal, original, files, drive = msr_object
    shutil.rmtree(tmp_path / f"d{drive[1]}" / "b" / "o")
    lose_and_heal(6)
    assert files() == original
    assert repair.stats_snapshot()["parts_repaired"] == 0


def test_a_device_error_is_not_caught(msr_object, monkeypatch):
    """A failed launch propagates: the dense heal would run the same
    kernel."""
    lose_and_heal, *_ = msr_object

    def launch_failed(*args, **kw):
        raise RuntimeError("gf_apply_launch: CUDA error 700")

    monkeypatch.setattr(repair, "_apply", launch_failed)
    with pytest.raises(RuntimeError, match="CUDA error"):
        lose_and_heal(3)
    assert repair.stats_snapshot()["fallbacks"] == 0

"""Entry points of the port.

`entry()` is the twin of `__graft_entry__.entry()`: 12+4 parity over a
batch of 8 x 1 MiB blocks. `put_get_heal()` drives the erasure data plane
end to end on shard files: PUT, degraded GET (full and ranged), heal.
`object_put_get_heal()` drives the same through the object layer and the
drive storage: PutObject, GetObject healthy and degraded, HealObject and
a bitrot check on 16 drive directories at 12+4.
"""

from __future__ import annotations

import hashlib
import io
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from .erasure import device_engine
from .erasure.bitrot import (
    StreamingBitrotReader,
    StreamingBitrotWriter,
    bitrot_verify,
)
from .erasure.codec import Erasure
from .erasure.streaming import (
    decode_stream,
    encode_stream,
    heal_stream,
)
from .object import erasure_objects
from .object.sets import ErasureSets
from .ops import gf, highwayhash_torch, rs_cuda
from .ops.rs import apply_gf_matrix
from .storage.local import LocalStorage
from .utils import ceil_frac
from .utils.device import resolve_device
from .utils.errors import ErrFileCorrupt, ErrFileNotFound


def entry(device="cuda"):
    """Return (fn, args): fn(*args) is the 12+4 parity of 8 blocks of
    1 MiB from np.random.default_rng(0), on `device`."""
    dev = resolve_device(device)
    k, m, batch = 12, 4, 8
    shard = ceil_frac(1 << 20, k)
    bitmat = gf.to_device_bitmat(gf.bit_matrix(gf.parity_matrix(k, m)), dev)
    rng = np.random.default_rng(0)
    blocks = torch.from_numpy(
        rng.integers(0, 256, size=(batch, k, shard), dtype=np.uint8)).to(dev)
    return apply_gf_matrix, (bitmat, blocks)


def counters() -> dict:
    """Device-engine STATS plus the kernels' own launch counts."""
    snap = device_engine.stats_snapshot()
    snap["kernel_gf_launches"] = rs_cuda.LAUNCHES
    snap["kernel_hash_launches"] = highwayhash_torch.LAUNCHES
    return snap


def _delta(before: dict, after: dict) -> dict:
    return {key: after[key] - before[key] for key in after}


def _phases(device: torch.device, out: dict):
    """phase(name, fn): run fn between two device syncs, recording its
    seconds and counter deltas under `name` in out."""
    def phase(name, fn):
        _sync(device)
        before = counters()
        t0 = time.perf_counter()
        result = fn()
        _sync(device)
        out["seconds"][name] = time.perf_counter() - t0
        out["counters"][name] = _delta(before, counters())
        return result
    return phase


def _shard_path(root: Path, i: int) -> Path:
    return root / f"disk{i}" / "part.1"


def _reader(path: Path, size: int, erasure: Erasure):
    def open_stream(offset: int, length: int):
        try:
            f = open(path, "rb")
        except FileNotFoundError as exc:
            raise ErrFileNotFound(str(path)) from exc
        f.seek(offset)
        return f

    return StreamingBitrotReader(open_stream, size, erasure.shard_size(),
                                 device=erasure.device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def put_get_heal(root, size: int, k: int = 12, m: int = 4,
                 lost=(0, 5, 12, 15), seed: int = 0, device="cuda",
                 block_size: int = 1 << 20) -> dict:
    """PUT a seeded payload of `size` bytes as root/disk{i}/part.1 shard
    files, remove the `lost` shards, GET it back degraded (whole, and one
    unaligned range), heal the lost shards, and re-verify every frame.

    Returns the GET bytes, each phase's seconds and counter deltas, and
    the checks: get_ok, range_ok, healed_identical, reverified."""
    root = Path(root)
    dev = resolve_device(device)
    erasure = Erasure(k, m, block_size, device=dev)
    payload = np.random.default_rng(seed).bytes(size)
    quorum = k + 1 if k == m else k
    out: dict = {"size": size, "k": k, "m": m, "lost": list(lost),
                 "seconds": {}, "counters": {}}
    phase = _phases(dev, out)

    # PUT
    for i in range(k + m):
        _shard_path(root, i).parent.mkdir(parents=True, exist_ok=True)
    files = [open(_shard_path(root, i), "wb") for i in range(k + m)]
    try:
        writers = [StreamingBitrotWriter(f, device=dev) for f in files]
        n = phase("put", lambda: encode_stream(
            erasure, io.BytesIO(payload), writers, quorum))
    finally:
        for f in files:
            f.close()
    if n != size:
        raise AssertionError(f"PUT consumed {n} bytes, want {size}")
    originals = {i: _shard_path(root, i).read_bytes() for i in lost}
    for i in lost:
        _shard_path(root, i).unlink()

    # Degraded GET, whole object then an unaligned range.
    def readers():
        return [_reader(_shard_path(root, i), size, erasure)
                for i in range(k + m)]

    sink = io.BytesIO()
    _, hint = phase("get", lambda: decode_stream(
        erasure, sink, readers(), 0, size, size))
    got = sink.getvalue()
    out["get_ok"] = got == payload
    out["heal_hint"] = type(hint).__name__ if hint is not None else None
    r_off = min(size - 1, 3 * block_size + 12345)
    r_len = min(size - r_off, 5 * block_size + 777)
    rsink = io.BytesIO()
    phase("range_get", lambda: decode_stream(
        erasure, rsink, readers(), r_off, r_len, size))
    out["range_ok"] = rsink.getvalue() == payload[r_off: r_off + r_len]

    # Heal the lost shards from the survivors.
    files = {i: open(_shard_path(root, i), "wb") for i in lost}
    try:
        hwriters = [StreamingBitrotWriter(files[i], device=dev)
                    if i in files else None for i in range(k + m)]
        hreaders = [None if i in files else
                    _reader(_shard_path(root, i), size, erasure)
                    for i in range(k + m)]
        phase("heal", lambda: heal_stream(erasure, hwriters, hreaders, size))
    finally:
        for f in files.values():
            f.close()
    out["healed_identical"] = all(
        _shard_path(root, i).read_bytes() == originals[i] for i in lost)

    def reverify():
        for i in range(k + m):
            path = _shard_path(root, i)
            with open(path, "rb") as f:
                bitrot_verify(f, path.stat().st_size,
                              erasure.shard_file_size(size),
                              erasure.shard_size(), device=dev)
        return True

    out["reverified"] = phase("verify", reverify)
    out["bytes"] = got
    return out


OBJECT_BUCKET = "smoke"
OBJECT_LOST = (0, 5, 12, 15)  # data 0, 5; parity 12, 15 at 12+4


def object_put_get_heal(root, size: int, device="cuda",
                        inline_size: int = 100 << 10, seed: int = 0) -> dict:
    """Drive the object layer over 16 fresh drive directories under
    `root`, one 12+4 set: init_format, make_bucket, then

    1. PutObject of a seeded `size`-byte object and an inline one of
       `inline_size` bytes;
    2. GetObject of both, every shard present;
    3. losses by shard index, mapped to drives through the object's
       distribution: part.1 of data shards 0 and 5 deleted, shard 12's
       object directory removed, part.1 of shard 15 truncated;
    4. degraded GetObject, whole and an unaligned range;
    5. HealObject, then the rebuilt part.1 and xl.meta files against the
       SHA-256 of the originals, and verify_file on all 16 drives;
    6. one byte of data shard 3's part.1 flipped: a GetObject, and
       verify_file on that drive.

    Returns each phase's seconds and counter deltas (`counters()`) and
    the checks, each True when it held."""
    dev = resolve_device(device)
    root = Path(root)
    bucket, name, small_name = OBJECT_BUCKET, "object", "inline-object"
    disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}", device=dev)
             for i in range(16)]
    sets = ErasureSets(disks, 16, default_parity=4, device=dev)
    sets.init_format()
    sets.make_bucket(bucket)
    rng = np.random.default_rng(seed)
    payload, small = rng.bytes(size), rng.bytes(inline_size)
    out: dict = {"size": size, "inline_size": inline_size, "k": 12, "m": 4,
                 "lost": list(OBJECT_LOST), "seconds": {}, "counters": {}}
    phase = _phases(dev, out)
    checks: dict = {}

    def get(obj, offset=0, length=-1) -> bytes:
        sink = io.BytesIO()
        sets.get_object(bucket, obj, sink, offset, length)
        return sink.getvalue()

    phase("put", lambda: sets.put_object(bucket, name, io.BytesIO(payload),
                                         size))
    phase("put_inline", lambda: sets.put_object(
        bucket, small_name, io.BytesIO(small), inline_size))
    checks["get_ok"] = phase("get", lambda: get(name)) == payload
    checks["inline_get_ok"] = phase("get_inline",
                                    lambda: get(small_name)) == small
    fi = disks[0].read_version(bucket, name)
    checks["inline_stored_inline"] = bool(
        disks[0].read_version(bucket, small_name, read_data=True).data)
    shard_disk = {d - 1: i for i, d in enumerate(fi.erasure.distribution)}

    def obj_dir(shard: int) -> Path:
        return root / f"d{shard_disk[shard]}" / bucket / name

    def part(shard: int) -> Path:
        return obj_dir(shard) / fi.data_dir / "part.1"

    def digests(shard: int) -> tuple:
        return tuple(hashlib.sha256(p.read_bytes()).hexdigest()
                     for p in (part(shard), obj_dir(shard) / "xl.meta"))

    originals = {s: digests(s) for s in OBJECT_LOST}
    part(0).unlink()
    part(5).unlink()
    shutil.rmtree(obj_dir(12))
    with open(part(15), "r+b") as f:
        f.truncate(part(15).stat().st_size // 2)

    the_set = sets.get_hashed_set(name)
    the_set.drain_mrf()
    checks["degraded_get_ok"] = phase("degraded_get",
                                      lambda: get(name)) == payload
    checks["degraded_get_queued_heal"] = the_set.drain_mrf() == [
        (bucket, name, "")]
    block = erasure_objects.BLOCK_SIZE_V2
    r_off = min(size - 1, 3 * block + 12345)
    r_len = min(size - r_off, 5 * block + 777)
    checks["range_ok"] = phase("range_get", lambda: get(
        name, r_off, r_len)) == payload[r_off:r_off + r_len]

    healed = phase("heal", lambda: sets.heal_object(bucket, name))
    out["heal_result"] = healed
    checks["heal_result_ok"] = healed == {
        "healed": [f"d{shard_disk[s]}" for s in OBJECT_LOST],
        "dangling": False}
    checks["healed_identical"] = all(digests(s) == originals[s]
                                     for s in OBJECT_LOST)

    def verify_all() -> bool:
        for disk in disks:
            for obj in (name, small_name):
                disk.verify_file(bucket, obj, disk.read_version(
                    bucket, obj, read_data=True))
        return True

    checks["verified_all"] = phase("verify", verify_all)

    bad = part(3)
    with open(bad, "r+b") as f:
        f.seek(32 + fi.erasure.shard_size() // 2)
        byte = f.read(1)[0]
        f.seek(-1, io.SEEK_CUR)
        f.write(bytes([byte ^ 0x5A]))
    the_set.drain_mrf()  # the range GET queued the object too
    checks["bitrot_get_ok"] = phase("bitrot_get",
                                    lambda: get(name)) == payload
    checks["bitrot_get_queued_heal"] = the_set.drain_mrf() == [
        (bucket, name, "")]
    bad_disk = disks[shard_disk[3]]

    def verify_bad() -> bool:
        try:
            bad_disk.verify_file(bucket, name,
                                 bad_disk.read_version(bucket, name))
        except ErrFileCorrupt:
            return True
        return False

    checks["bitrot_detected"] = phase("bitrot_verify", verify_bad)
    out["checks"] = checks
    return out

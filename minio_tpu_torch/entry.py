"""Entry points of the port.

`entry()` is the twin of `__graft_entry__.entry()`: 12+4 parity over a
batch of 8 x 1 MiB blocks. `put_get_heal()` drives the erasure data plane
end to end on shard files: PUT, degraded GET (full and ranged), heal.
`object_put_get_heal()` drives the same through the object layer and the
drive storage: PutObject, GetObject healthy and degraded, HealObject and
a bitrot check on 16 drive directories at 12+4;
`object_codec_put_get_heal()` does it under one erasure codec at any
set size, with a heal of one lost drive through the repair plane.
`s3_put_get_heal()` drives the S3 server over HTTP on localhost: signed
PUTs (aws-chunked, multipart, small objects), listing, GETs, lost
drives, degraded GETs and an admin heal; `s3_codec_put_get()` one PUT
with the x-mtpu-codec header.
"""

from __future__ import annotations

import hashlib
import io
import json
import re
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .erasure import device_engine, registry, repair, streaming
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
from .api.client import S3Client
from .object import erasure_objects
from .object.sets import ErasureSets
from .object.types import ObjectOptions
from .ops import gf, highwayhash_torch, host_feed, rs_cuda
from .ops.rs import apply_gf_matrix
from .server import Server
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
    """Device-engine STATS, the fan-out and reader counters, the copies
    to the card by kind (pinned or pageable), and the kernels' own launch
    counts."""
    snap = device_engine.stats_snapshot()
    snap.update(streaming.stats_snapshot())
    snap.update({f"h2d_{k}": v for k, v in host_feed.h2d_snapshot().items()})
    snap.update({f"repair_{k}": v for k, v in repair.stats_snapshot().items()})
    snap["kernel_gf_launches"] = rs_cuda.LAUNCHES.value
    snap["kernel_hash_launches"] = highwayhash_torch.LAUNCHES.value
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

    r = StreamingBitrotReader(open_stream, size, erasure.shard_size(),
                              device=erasure.device)
    r.local = True
    return r


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def put_get_heal(root, size: int, k: int = 12, m: int = 4,
                 lost=(0, 5, 12, 15), seed: int = 0, device="cuda",
                 block_size: int = 1 << 20) -> dict:
    """PUT a seeded payload of `size` bytes as root/disk{i}/part.1 shard
    files, GET it back, remove the `lost` shards, GET it back degraded
    (whole, and one unaligned range), heal the lost shards, and re-verify
    every frame. Which drivers run is `utils.fanout.SINGLE_CORE`'s
    choice (serial when True, pipelined when False).

    Returns the GET bytes, the SHA-256 of each shard file as PUT wrote
    it, each phase's seconds and counter deltas, and the checks:
    healthy_get_ok, get_ok, range_ok, healed_identical, reverified."""
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
    out["shard_sha256"] = [hashlib.sha256(
        _shard_path(root, i).read_bytes()).hexdigest() for i in range(k + m)]

    def readers():
        return [_reader(_shard_path(root, i), size, erasure)
                for i in range(k + m)]

    # Healthy GET, then the lost shards go, then a degraded GET, whole
    # object and an unaligned range.
    sink = io.BytesIO()
    _, hint = phase("get_healthy", lambda: decode_stream(
        erasure, sink, readers(), 0, size, size))
    out["healthy_get_ok"] = sink.getvalue() == payload and hint is None
    originals = {i: _shard_path(root, i).read_bytes() for i in lost}
    for i in lost:
        _shard_path(root, i).unlink()

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


# How object_codec_put_get_heal loses the shards of `lost`, in turn:
# part.1 deleted twice, the object's directory removed, part.1 cut in
# half (the losses of object_put_get_heal).
_LOSSES = ("unlink", "unlink", "rmtree", "truncate")


def object_codec_put_get_heal(root, size: int, codec: str,
                              drives: int = 16, parity: int = 4,
                              lost=OBJECT_LOST, repair_target=None,
                              device="cuda", seed: int = 0) -> dict:
    """Drive the object layer under one erasure codec: `drives` fresh
    drive directories under `root` as one set of default parity
    `parity`, then

    1. PutObject of a seeded `size`-byte object with
       ObjectOptions(codec=codec), and its xl.meta checked to name the
       codec and its wire algorithm;
    2. GetObject, every shard present;
    3. the shards `lost` lost (by shard index, mapped to drives through
       the object's distribution; in turn part.1 deleted, part.1
       deleted, the object directory removed, part.1 cut in half);
    4. degraded GetObject, whole and an unaligned range;
    5. HealObject, then each rebuilt part.1 and xl.meta against the
       SHA-256 of its original;
    6. when `repair_target` is a shard index: that shard's drive loses
       the object, and HealObject rebuilds it through the repair plane
       (erasure/repair.py): one part repaired, no fallback, the bytes
       read a byte healed equal to the plan's total_symbols / alpha,
       and the rebuilt files equal to the originals.

    Returns each phase's seconds and counter deltas (`counters()`, the
    repair plane's STATS under "repair_"), the repair ratio, and the
    checks, each True when it held."""
    dev = resolve_device(device)
    root = Path(root)
    bucket, name = OBJECT_BUCKET, "object"
    disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}", device=dev)
             for i in range(drives)]
    sets = ErasureSets(disks, drives, default_parity=parity, device=dev)
    sets.init_format()
    sets.make_bucket(bucket)
    payload = np.random.default_rng(seed).bytes(size)
    out: dict = {"size": size, "codec": codec, "k": drives - parity,
                 "m": parity, "lost": list(lost),
                 "repair_target": repair_target, "seconds": {},
                 "counters": {}}
    phase = _phases(dev, out)
    checks: dict = {}

    def get(offset=0, length=-1) -> bytes:
        sink = io.BytesIO()
        sets.get_object(bucket, name, sink, offset, length)
        return sink.getvalue()

    phase("put", lambda: sets.put_object(bucket, name, io.BytesIO(payload),
                                         size, ObjectOptions(codec=codec)))
    fi = disks[0].read_version(bucket, name)
    checks["codec_stamped"] = (
        fi.erasure.codec == codec
        and fi.erasure.algorithm == registry.get(codec).wire_algorithm)
    checks["get_ok"] = phase("get", get) == payload
    shard_disk = {d - 1: i for i, d in enumerate(fi.erasure.distribution)}

    def obj_dir(shard: int) -> Path:
        return root / f"d{shard_disk[shard]}" / bucket / name

    def part(shard: int) -> Path:
        return obj_dir(shard) / fi.data_dir / "part.1"

    def digests(shard: int) -> tuple:
        return tuple(hashlib.sha256(p.read_bytes()).hexdigest()
                     for p in (part(shard), obj_dir(shard) / "xl.meta"))

    originals = {s: digests(s) for s in range(drives)}
    for i, s in enumerate(lost):
        loss = _LOSSES[i % len(_LOSSES)]
        if loss == "unlink":
            part(s).unlink()
        elif loss == "rmtree":
            shutil.rmtree(obj_dir(s))
        else:
            with open(part(s), "r+b") as f:
                f.truncate(part(s).stat().st_size // 2)
    checks["degraded_get_ok"] = phase("degraded_get", get) == payload
    block = erasure_objects.BLOCK_SIZE_V2
    r_off = min(size - 1, 3 * block + 12345)
    r_len = min(size - r_off, 5 * block + 777)
    checks["range_ok"] = phase("range_get", lambda: get(
        r_off, r_len)) == payload[r_off:r_off + r_len]
    healed = phase("heal", lambda: sets.heal_object(bucket, name))
    checks["heal_result_ok"] = healed == {
        "healed": [f"d{shard_disk[s]}" for s in sorted(lost)],
        "dangling": False}
    checks["healed_identical"] = all(digests(s) == originals[s]
                                     for s in lost)

    if repair_target is not None:
        shutil.rmtree(obj_dir(repair_target))
        healed = phase("repair_heal", lambda: sets.heal_object(bucket, name))
        c = out["counters"]["repair_heal"]
        plan = registry.get(codec).repair_plan(drives - parity, parity,
                                               repair_target)
        ratio = (c["repair_bytes_read"] / c["repair_bytes_written"]
                 if c["repair_bytes_written"] else float("nan"))
        out["repair"] = {"bytes_read": c["repair_bytes_read"],
                         "bytes_written": c["repair_bytes_written"],
                         "ratio": ratio,
                         "plan_ratio": plan.total_symbols / plan.alpha}
        checks["repair_result_ok"] = healed == {
            "healed": [f"d{shard_disk[repair_target]}"], "dangling": False}
        checks["repaired_by_plane"] = (c["repair_parts_repaired"] == 1
                                       and c["repair_fallbacks"] == 0)
        checks["repair_ratio_ok"] = ratio == plan.total_symbols / plan.alpha
        checks["repaired_identical"] = (digests(repair_target)
                                        == originals[repair_target])
        checks["get_after_repair_ok"] = get() == payload
    out["checks"] = checks
    return out


def s3_codec_put_get(root, size: int, codec: str, device="cuda",
                     seed: int = 0) -> dict:
    """A Server over 16 fresh drive directories under `root` (one 12+4
    set) takes one signed PUT of a seeded `size`-byte object with the
    header x-mtpu-codec: `codec`, and one GET of it. Returns the seconds
    and counter deltas of both, and the checks: the PUT's ETag, the GET's
    bytes, and the codec id xl.meta names on every drive."""
    dev = resolve_device(device)
    root = Path(root)
    payload = np.random.default_rng(seed).bytes(size)
    out: dict = {"size": size, "codec": codec, "seconds": {},
                 "counters": {}}
    phase = _phases(dev, out)
    checks: dict = {}
    key = f"/{S3_BUCKET}/codec.bin"
    server = Server([str(root / "d{1...16}")], port=0,
                    root_user=S3_ACCESS, root_password=S3_SECRET,
                    default_parity=4, device=dev).start()
    try:
        c = S3Client(server.endpoint, S3_ACCESS, S3_SECRET)
        checks["make_bucket_ok"] = c.request("PUT", f"/{S3_BUCKET}")[0] == 200
        status, headers, _ = phase("put", lambda: c.request(
            "PUT", key, headers={"x-mtpu-codec": codec}, body=payload))
        checks["put_ok"] = (status == 200 and headers.get("ETag") ==
                            f'"{hashlib.md5(payload).hexdigest()}"')
        status, _, body = phase("get", lambda: c.request("GET", key))
        checks["get_ok"] = status == 200 and body == payload
    finally:
        server.stop()
    codecs = {LocalStorage(str(root / f"d{i}"), device=dev).read_version(
        S3_BUCKET, key.rsplit("/", 1)[1]).erasure.codec
        for i in range(1, 17)}
    out["xl_meta_codecs"] = sorted(codecs)
    checks["codec_stamped"] = codecs == {codec}
    out["checks"] = checks
    return out


S3_BUCKET = "smoke"
S3_WIPED = (0, 5, 12, 15)  # drives of the set whose objects are all lost
S3_ACCESS, S3_SECRET = "smoke-admin", "smoke-admin-secret"
SMALL_SIZES = (1 << 10, (4 << 10) + 1, 33 << 10, 100 << 10)


def s3_object_names(small_count: int) -> list[str]:
    """The keys s3_put_get_heal writes: the aws-chunked object, the
    multipart one, then `small_count` small ones under four prefixes."""
    return ["big/chunked.bin", "big/multipart.bin"] + [
        f"small-{i % 4}/obj-{i:04d}" for i in range(small_count)]


def _heal_bucket(client: S3Client, bucket: str,
                 timeout_s: float = 600.0) -> dict:
    """Start an admin heal of `bucket` and poll it to its end."""
    path = f"/minio/admin/v3/heal/{bucket}"
    status, _, body = client.request("POST", path)
    if status != 200:
        raise AssertionError(f"admin heal: {status} {body[:200]!r}")
    token = json.loads(body)["clientToken"]
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        status, _, body = client.request("POST", path,
                                         [("clientToken", token)])
        state = json.loads(body)
        if status != 200 or state["Summary"] != "running":
            return state
        time.sleep(0.01)
    raise TimeoutError(f"heal of {bucket} still running after {timeout_s} s")


def _listed(client: S3Client, bucket: str, page: int,
            delimiter: str = "") -> tuple[list, list, int]:
    """Every key and common prefix of a ListObjectsV2 walk in pages of
    `page`, and the number of pages."""
    keys, prefixes, token, pages = [], [], "", 0
    while True:
        q = [("list-type", "2"), ("max-keys", str(page))]
        if delimiter:
            q.append(("delimiter", delimiter))
        if token:
            q.append(("continuation-token", token))
        status, _, body = client.request("GET", f"/{bucket}", q)
        if status != 200:
            raise AssertionError(f"list: {status} {body[:200]!r}")
        pages += 1
        keys += [k.decode() for k in re.findall(rb"<Key>(.*?)</Key>", body)]
        prefixes += [p.decode() for p in re.findall(
            rb"<CommonPrefixes><Prefix>(.*?)</Prefix>", body)]
        m = re.search(rb"<NextContinuationToken>(.*?)<", body)
        if not m:
            return keys, prefixes, pages
        token = m.group(1).decode()


def s3_put_get_heal(root, size: int, device="cuda",
                    part_size: int = 16 << 20, parts: int = 8,
                    last_part: int = 12_345, small_count: int = 256,
                    small_sizes=SMALL_SIZES, page: int = 100,
                    concurrent: int = 4, seed: int = 0) -> dict:
    """Drive the S3 plane over HTTP on localhost: a Server over 16 fresh
    drive directories under `root` (one 12+4 set), a client signing with
    the port's api/sign.py, and in order:

    1. MakeBucket; an aws-chunked PutObject of a seeded `size`-byte
       object; a multipart upload of `parts` parts of `part_size` bytes
       and a last one of `last_part`; `small_count` small objects, sizes
       cycling over `small_sizes`, under four prefixes;
    2. ListObjectsV2 in pages of `page`, without a delimiter and with
       "/";
    3. a whole GET and a ranged GET of the big object, then `concurrent`
       GETs at once of both big objects (bytes checked; their launches
       are not counted apart);
    4. every object of the bucket lost on drives 0, 5, 12 and 15, and
       degraded GETs of both big objects;
    5. an admin heal of the bucket, polled to its end, then every file
       of the lost drives against the SHA-256 of its original.

    Returns each serial phase's seconds and counter deltas
    (`counters()`), the concurrent GETs' seconds, the heal's final
    status, and the checks, each True when it held."""
    dev = resolve_device(device)
    root = Path(root)
    rng = np.random.default_rng(seed)
    payload = rng.bytes(size)
    mp_sizes = [part_size] * parts + ([last_part] if last_part else [])
    mp_payload = rng.bytes(sum(mp_sizes))
    big, mp, *small_names = s3_object_names(small_count)
    smalls = {name: rng.bytes(small_sizes[i % len(small_sizes)])
              for i, name in enumerate(small_names)}
    out: dict = {"size": size, "multipart_size": len(mp_payload),
                 "parts": len(mp_sizes), "small_count": small_count,
                 "k": 12, "m": 4, "wiped_drives": list(S3_WIPED),
                 "seconds": {}, "counters": {}}
    phase = _phases(dev, out)
    checks: dict = {}
    server = Server([str(root / "d{1...16}")], port=0,
                    root_user=S3_ACCESS, root_password=S3_SECRET,
                    default_parity=4, device=dev).start()
    try:
        c = S3Client(server.endpoint, S3_ACCESS, S3_SECRET)
        b = f"/{S3_BUCKET}"
        checks["make_bucket_ok"] = phase(
            "make_bucket", lambda: c.request("PUT", b))[0] == 200

        status, headers, _ = phase("put", lambda: c.put_chunked(
            f"{b}/{big}", payload))
        checks["put_ok"] = (status == 200 and headers.get("ETag") ==
                            f'"{hashlib.md5(payload).hexdigest()}"')

        def multipart():
            status, _, body = c.request("POST", f"{b}/{mp}", [("uploads", "")])
            upload = re.search(rb"<UploadId>(.*?)<", body).group(1).decode()
            etags, off = [], 0
            for n, ln in enumerate(mp_sizes, 1):
                status, h, _ = c.request(
                    "PUT", f"{b}/{mp}", [("partNumber", str(n)),
                                         ("uploadId", upload)],
                    body=mp_payload[off:off + ln])
                if status != 200:
                    return None
                etags.append(h["ETag"])
                off += ln
            xml = "<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
                for n, e in enumerate(etags, 1)) + \
                "</CompleteMultipartUpload>"
            status, _, body = c.request("POST", f"{b}/{mp}",
                                        [("uploadId", upload)],
                                        body=xml.encode())
            return status, body

        md5s = b"".join(hashlib.md5(mp_payload[o:o + ln]).digest()
                        for o, ln in zip(np.cumsum([0] + mp_sizes[:-1]),
                                         mp_sizes))
        want_etag = f"{hashlib.md5(md5s).hexdigest()}-{len(mp_sizes)}"
        done = phase("multipart", multipart)
        checks["multipart_ok"] = (done is not None and done[0] == 200 and
                                  f'"{want_etag}"'.encode() in done[1])

        def put_smalls() -> bool:
            return all(c.request("PUT", f"{b}/{k}", body=v)[0] == 200
                       for k, v in smalls.items())

        checks["small_ok"] = phase("put_small", put_smalls)

        keys, prefixes, pages = phase("list", lambda: _listed(c, S3_BUCKET,
                                                              page))
        checks["list_ok"] = keys == sorted([big, mp, *smalls])
        out["list_pages"] = pages
        keys, prefixes, _ = phase("list_delimiter", lambda: _listed(
            c, S3_BUCKET, page, "/"))
        checks["list_delimiter_ok"] = (keys == [] and prefixes == sorted(
            {"big/"} | {k.split("/")[0] + "/" for k in smalls}))

        status, _, got = phase("get", lambda: c.request("GET", f"{b}/{big}"))
        checks["get_ok"] = status == 200 and got == payload
        block = erasure_objects.BLOCK_SIZE_V2
        r_off = min(size - 1, 3 * block + 12345)
        r_len = min(size - r_off, 5 * block + 777)
        status, _, got = phase("range_get", lambda: c.request(
            "GET", f"{b}/{big}",
            headers={"Range": f"bytes={r_off}-{r_off + r_len - 1}"}))
        checks["range_ok"] = (status == 206 and
                              got == payload[r_off:r_off + r_len])

        results: list = [None] * concurrent
        wants = [(big, payload), (mp, mp_payload)]
        before = counters()

        def get_one(i):
            name, want = wants[i % 2]
            status, _, body = c.request("GET", f"{b}/{name}")
            results[i] = status == 200 and body == want

        threads = [threading.Thread(target=get_one, args=(i,))
                   for i in range(concurrent)]
        _sync(dev)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        _sync(dev)
        out["concurrent_get_seconds"] = time.perf_counter() - t0
        out["counters"]["concurrent_get"] = _delta(before, counters())
        checks["concurrent_get_ok"] = all(results)

        # Every object of the bucket lost on the wiped drives.
        wiped = [root / f"d{i + 1}" / S3_BUCKET for i in S3_WIPED]
        originals = {p: hashlib.sha256(p.read_bytes()).hexdigest()
                     for d in wiped for p in d.rglob("*") if p.is_file()}
        for d in wiped:
            for entry in d.iterdir():
                shutil.rmtree(entry)
        status, _, got = phase("degraded_get", lambda: c.request(
            "GET", f"{b}/{big}"))
        checks["degraded_get_ok"] = status == 200 and got == payload
        status, _, got = phase("degraded_get_multipart", lambda: c.request(
            "GET", f"{b}/{mp}"))
        checks["degraded_multipart_ok"] = status == 200 and got == mp_payload

        state = phase("heal", lambda: _heal_bucket(c, S3_BUCKET))
        out["heal"] = {k: state[k] for k in ("Summary", "NumScanned",
                                             "NumHealed", "NumFailed")}
        checks["heal_ok"] = (state["Summary"] == "finished" and
                             state["NumFailed"] == 0 and
                             state["NumHealed"] == 2 + small_count)
        checks["healed_identical"] = bool(originals) and all(
            p.is_file() and hashlib.sha256(p.read_bytes()).hexdigest() == h
            for p, h in originals.items())
        out["healed_files"] = len(originals)
    finally:
        server.stop()
    out["checks"] = checks
    return out

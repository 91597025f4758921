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
with the x-mtpu-codec header. `s3_core()` drives the S3 object core:
versioned PUTs, a delete marker, versioned GETs with drives lost,
CopyObject from the degraded source, UploadPartCopy, a metadata-only
self-copy, tagging, DeleteObjects, a bucket policy with anonymous
requests, and the heals of every version. `self_heal()` drives the
self-healing services of a whole running server: a drive outage with
writes (the MRF drain on reconnect), a replaced drive (the fresh-drive
sweep) and the scanner; `object_self_heal()` the same services on the
object layer, called directly. `s3_sse()` drives server-side encryption
over HTTP: SSE-S3, SSE-C and SSE-KMS PUTs, GETs whole and ranged, HEAD,
four drives lost, degraded GETs, HealObject (which never decrypts), a
CopyObject that re-encrypts, and a GET with the wrong SSE-C key.
"""

from __future__ import annotations

import base64
import contextlib
import hashlib
import io
import json
import os
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
from .api.handlers import copy_reads_snapshot
from .object import erasure_objects
from .object.sets import ErasureSets
from .object.types import ObjectOptions
from .crypto import sse as ssemod
from .ops import aes_gcm_cuda, gf, highwayhash_torch, host_feed, rs_cuda
from .ops.rs import apply_gf_matrix
from .server import Server
from .storage.local import LocalStorage
from .storage.xlmeta import XLMeta
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
    snap.update({f"copy_{k}": v for k, v in copy_reads_snapshot().items()})
    snap["kernel_gf_launches"] = rs_cuda.LAUNCHES.value
    snap["kernel_hash_launches"] = highwayhash_torch.LAUNCHES.value
    snap["kernel_seal_launches"] = aes_gcm_cuda.SEAL_LAUNCHES.value
    snap["kernel_open_launches"] = aes_gcm_cuda.OPEN_LAUNCHES.value
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
                    default_parity=4, device=dev)
    # The S3 plane alone: the background services (Server.start()) would
    # heal this entry's degraded objects and write the scanner's usage
    # object meanwhile, which its launch counts and checks do not expect.
    server.s3.start()
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
                    default_parity=4, device=dev)
    # The S3 plane alone: the background services (Server.start()) would
    # heal this entry's degraded objects and write the scanner's usage
    # object meanwhile, which its launch counts and checks do not expect.
    server.s3.start()
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


ENABLED_XML = (b"<VersioningConfiguration><Status>Enabled</Status>"
               b"</VersioningConfiguration>")


def part_copy_ranges(size: int) -> list[tuple[int, int]]:
    """The three x-amz-copy-source-range spans (first, last) s3_core's
    UploadPartCopy takes from a `size`-byte source: whole blocks to a
    quarter of it, then to three quarters plus 7 bytes, then the rest,
    so that the last two parts end in ragged blocks."""
    block = erasure_objects.BLOCK_SIZE_V2
    quarter = size // 4 // block * block
    if quarter == 0:
        raise ValueError(f"a {size}-byte source has fewer than 4 blocks "
                         f"of {block} B")
    cuts = (0, quarter, 3 * quarter + 7, size)
    return [(a, b - 1) for a, b in zip(cuts, cuts[1:])]


def _listed_versions(client: S3Client, bucket: str, prefix: str,
                     page: int) -> tuple[list, int]:
    """Every (key, version id, delete marker, latest) of a paged
    ListObjectVersions walk, and the number of pages."""
    entries, key_marker, vid_marker, pages = [], "", "", 0
    while True:
        q = [("versions", ""), ("prefix", prefix), ("max-keys", str(page))]
        if key_marker:
            q += [("key-marker", key_marker),
                  ("version-id-marker", vid_marker)]
        status, _, body = client.request("GET", f"/{bucket}", q)
        if status != 200:
            raise AssertionError(f"versions: {status} {body[:200]!r}")
        pages += 1
        for kind, block in re.findall(
                rb"<(Version|DeleteMarker)>(.*?)</\1>", body, re.S):
            entries.append((
                re.search(rb"<Key>(.*?)</Key>", block).group(1).decode(),
                re.search(rb"<VersionId>(.*?)</VersionId>",
                          block).group(1).decode(),
                kind == b"DeleteMarker",
                b"<IsLatest>true</IsLatest>" in block))
        if b"<IsTruncated>true</IsTruncated>" not in body:
            return entries, pages
        key_marker = re.search(rb"<NextKeyMarker>(.*?)<",
                               body).group(1).decode()
        vid_marker = re.search(rb"<NextVersionIdMarker>(.*?)<",
                               body).group(1).decode()


def _part_digests(root: Path, bucket: str, prefix: str = "") -> dict:
    """SHA-256 of every part file of the bucket's objects under `prefix`
    on the 16 drives."""
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for i in range(1, 17)
            for p in (root / f"d{i}" / bucket).glob(f"{prefix}**/part.*")
            if p.is_file()}


def _journal(root: Path, drive: int, bucket: str, name: str):
    """(version id, mod time, delete marker) of each version in a drive's
    xl.meta of the object, None when it has none."""
    path = root / f"d{drive}" / bucket / name / "xl.meta"
    if not path.is_file():
        return None
    return [(v["vid"], v["mt"], v["del"])
            for v in XLMeta.from_bytes(path.read_bytes()).versions]


def _wipe(root: Path, bucket: str) -> None:
    """Every object of the bucket lost on the drives of S3_WIPED."""
    for i in S3_WIPED:
        for entry in (root / f"d{i + 1}" / bucket).iterdir():
            shutil.rmtree(entry)


def s3_core(root, size: int, device="cuda", small_count: int = 256,
            small_size: int = 1 << 10, page: int = 100,
            seed: int = 0) -> dict:
    """Drive the S3 object core over HTTP on localhost: a Server over 16
    fresh drive directories under `root` (one 12+4 set), one client
    signing with the port's api/sign.py, the object writes stamped
    dense-gf8 (x-mtpu-codec), and in order:

    1. MakeBucket ver, PUT ?versioning Enabled, GET ?versioning;
       MakeBucket dst, unversioned;
    2. two PUTs of ver/big, `size` bytes each: v1 = payload A, then
       v2 = payload B with x-amz-tagging; ListObjectVersions;
    3. DELETE ver/big (a delete marker); a GET (404); GETs of v1 and v2
       by versionId;
    4. ver's objects lost on drives 0, 5, 12 and 15; a degraded GET of
       v1 by versionId;
    5. CopyObject of ver/big?versionId=v1 to dst/copy from the degraded
       source; a GET of it;
    6. a multipart upload of dst/parts from three UploadPartCopy parts
       of v2 (part_copy_ranges); Complete; a GET of it;
    7. a self-copy of dst/copy with x-amz-metadata-directive REPLACE,
       metadata only: its part files keep their bytes;
    8. tagging of v1: put, get, delete; a HEAD of v2 (its tag count);
    9. `small_count` PUTs of `small_size` bytes under small/ in ver, one
       POST ?delete of all of them, ListObjectsV2 of ver (empty: every
       latest version is a delete marker), ListObjectVersions of small/
       in pages of `page` (2 x small_count entries);
    10. a bucket policy on dst letting anonymous requests GET public/*:
        anonymous GETs of dst/public/x (200) and dst/copy (403), an
        anonymous PUT (403), and after DELETE ?policy the first GET
        again (403);
    11. dst's objects lost on the same drives; an admin heal of dst
        polled to its end; heal_object of ver/big at v1, v2 and the
        marker (the heal walk visits latest versions only); every part
        file of both buckets then equal to its pre-loss copy by SHA-256,
        and each healed drive's journal of ver/big equal to a surviving
        drive's.

    Returns each step's seconds and counter deltas (`counters()`, with
    the copy pulls and bytes read), the bytes each copy read and wrote,
    and the checks, each True when it held."""
    dev = resolve_device(device)
    root = Path(root)
    rng = np.random.default_rng(seed)
    payload_a, payload_b = rng.bytes(size), rng.bytes(size)
    small = rng.bytes(small_size)
    out: dict = {"size": size, "k": 12, "m": 4,
                 "wiped_drives": list(S3_WIPED), "small_count": small_count,
                 "part_copy_ranges": part_copy_ranges(size),
                 "seconds": {}, "counters": {}}
    phase = _phases(dev, out)
    checks: dict = {}
    dense = {"x-mtpu-codec": "dense-gf8"}
    server = Server([str(root / "d{1...16}")], port=0,
                    root_user=S3_ACCESS, root_password=S3_SECRET,
                    default_parity=4, device=dev)
    # The S3 plane alone: the background services (Server.start()) would
    # heal this entry's degraded objects and write the scanner's usage
    # object meanwhile, which its launch counts and checks do not expect.
    server.s3.start()
    try:
        c = S3Client(server.endpoint, S3_ACCESS, S3_SECRET)
        big = "/ver/big"

        def versioning():
            return [c.request("PUT", "/ver")[0],
                    c.request("PUT", "/ver", [("versioning", "")],
                              body=ENABLED_XML)[0],
                    c.request("GET", "/ver", [("versioning", "")]),
                    c.request("PUT", "/dst")[0]]

        got = phase("versioning", versioning)
        checks["versioning_ok"] = (got[:2] == [200, 200] and got[3] == 200
                                   and b"<Status>Enabled</Status>"
                                   in got[2][2])

        # 2. Two versions, the second tagged.
        _, h, _ = phase("put_v1", lambda: c.request(
            "PUT", big, headers=dense, body=payload_a))
        v1 = h.get("x-amz-version-id", "")
        _, h, _ = phase("put_v2", lambda: c.request(
            "PUT", big, headers={**dense, "x-amz-tagging":
                                 "team=storage&copy=none"},
            body=payload_b))
        v2 = h.get("x-amz-version-id", "")
        listed, _ = phase("list_versions", lambda: _listed_versions(
            c, "ver", "big", page))
        checks["two_versions_ok"] = bool(v1 and v2 and v1 != v2) and \
            listed == [("big", v2, False, True), ("big", v1, False, False)]

        # 3. A delete marker over both.
        status, h, _ = phase("delete_marker", lambda: c.request("DELETE",
                                                                big))
        marker = h.get("x-amz-version-id", "")
        checks["delete_marker_ok"] = (status == 204 and h.get(
            "x-amz-delete-marker") == "true" and marker not in ("", v1, v2))
        status, _, body = phase("get_marked", lambda: c.request("GET", big))
        checks["get_marked_404"] = (status == 404
                                    and b"<Code>NoSuchKey</Code>" in body)
        for name, vid, want in (("get_v1", v1, payload_a),
                                ("get_v2", v2, payload_b)):
            status, _, body = phase(name, lambda vid=vid: c.request(
                "GET", big, [("versionId", vid)]))
            checks[f"{name}_ok"] = status == 200 and body == want

        # 4. Drives lost; v1 read degraded.
        ver_digests = _part_digests(root, "ver")
        _wipe(root, "ver")
        status, _, body = phase("degraded_get_v1", lambda: c.request(
            "GET", big, [("versionId", v1)]))
        checks["degraded_get_v1_ok"] = status == 200 and body == payload_a

        # 5. CopyObject from the degraded source.
        status, _, body = phase("copy", lambda: c.request(
            "PUT", "/dst/copy",
            headers={"x-amz-copy-source": f"{big}?versionId={v1}"}))
        etag_a = hashlib.md5(payload_a).hexdigest()
        checks["copy_ok"] = status == 200 and f'"{etag_a}"'.encode() in body
        status, _, body = phase("get_copy", lambda: c.request("GET",
                                                              "/dst/copy"))
        checks["get_copy_ok"] = status == 200 and body == payload_a

        # 6. UploadPartCopy of v2 in three ranges, the last two ragged.
        def part_copy():
            status, _, body = c.request("POST", "/dst/parts",
                                        [("uploads", "")], headers=dense)
            upload = re.search(rb"<UploadId>(.*?)<", body).group(1).decode()
            etags = []
            for n, (first, last) in enumerate(part_copy_ranges(size), 1):
                status, _, body = c.request(
                    "PUT", "/dst/parts", [("partNumber", str(n)),
                                          ("uploadId", upload)],
                    headers={"x-amz-copy-source": f"{big}?versionId={v2}",
                             "x-amz-copy-source-range":
                                 f"bytes={first}-{last}"})
                if status != 200:
                    return status, body
                etags.append(re.search(rb"<ETag>(.*?)</ETag>",
                                       body).group(1).decode())
            xml = "<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
                for n, e in enumerate(etags, 1)) + \
                "</CompleteMultipartUpload>"
            status, _, body = c.request("POST", "/dst/parts",
                                        [("uploadId", upload)],
                                        body=xml.encode())
            return status, body

        status, _ = phase("part_copy", part_copy)
        checks["part_copy_ok"] = status == 200
        status, _, body = phase("get_parts", lambda: c.request(
            "GET", "/dst/parts"))
        checks["get_parts_ok"] = status == 200 and body == payload_b

        # 7. A metadata-only self-copy.
        before = _part_digests(root, "dst", "copy/")
        status, _, _ = phase("self_copy", lambda: c.request(
            "PUT", "/dst/copy", headers={
                "x-amz-copy-source": "/dst/copy",
                "x-amz-metadata-directive": "REPLACE",
                "x-amz-meta-note": "replaced"}))
        _, h, _ = c.request("HEAD", "/dst/copy")
        checks["self_copy_ok"] = (status == 200 and h.get("x-amz-meta-note")
                                  == "replaced")
        checks["self_copy_parts_unchanged"] = bool(before) and \
            _part_digests(root, "dst", "copy/") == before

        # 8. Tagging of v1.
        def tagging():
            q = [("tagging", ""), ("versionId", v1)]
            xml = (b"<Tagging><TagSet><Tag><Key>tier</Key><Value>cold"
                   b"</Value></Tag></TagSet></Tagging>")
            return (c.request("PUT", big, q, body=xml)[0],
                    c.request("GET", big, q)[2],
                    c.request("DELETE", big, q)[0],
                    c.request("GET", big, q)[2],
                    c.request("HEAD", big, [("versionId", v2)])[1])

        put_s, tags, del_s, tags_after, head_v2 = phase("tagging", tagging)
        checks["tagging_ok"] = (
            put_s == 200 and b"<Key>tier</Key>" in tags and del_s == 204
            and b"<Tag>" not in tags_after
            and head_v2.get("x-amz-tagging-count") == "2")

        # 9. Small objects, one DeleteObjects, the listings.
        names = [f"small/obj-{i:04d}" for i in range(small_count)]
        checks["small_put_ok"] = phase("put_small", lambda: all(
            c.request("PUT", f"/ver/{n}", headers=dense,
                      body=small)[0] == 200 for n in names))
        delete_xml = ("<Delete>" + "".join(
            f"<Object><Key>{n}</Key></Object>" for n in names)
            + "</Delete>").encode()
        status, _, body = phase("delete_objects", lambda: c.request(
            "POST", "/ver", [("delete", "")], body=delete_xml))
        checks["delete_objects_ok"] = (status == 200 and body.count(
            b"<Deleted>") == small_count and b"<Error>" not in body)
        keys, prefixes, _ = phase("list_after_delete", lambda: _listed(
            c, "ver", page))
        checks["list_empty"] = keys == [] and prefixes == []
        listed, pages = phase("list_versions_small", lambda: _listed_versions(
            c, "ver", "small/", page))
        out["version_pages"] = pages
        checks["list_versions_ok"] = (
            len(listed) == 2 * small_count
            and sorted({e[0] for e in listed}) == names
            and sum(e[2] for e in listed) == small_count
            and all(e[3] == e[2] for e in listed))

        # 10. A bucket policy and anonymous requests.
        policy = json.dumps({"Version": "2012-10-17", "Statement": [{
            "Effect": "Allow", "Principal": {"AWS": ["*"]},
            "Action": ["s3:GetObject"],
            "Resource": ["arn:aws:s3:::dst/public/*"]}]}).encode()

        def policy_calls():
            c.request("PUT", "/dst/public/x", headers=dense, body=small)
            put = c.request("PUT", "/dst", [("policy", "")], body=policy)[0]
            anon = [c.request("GET", "/dst/public/x", anonymous=True),
                    c.request("GET", "/dst/copy", anonymous=True),
                    c.request("PUT", "/dst/public/y", body=small,
                              anonymous=True)]
            deleted = c.request("DELETE", "/dst", [("policy", "")])[0]
            after = c.request("GET", "/dst/public/x", anonymous=True)
            return put, anon, deleted, after

        put, anon, deleted, after = phase("policy", policy_calls)
        checks["policy_ok"] = (
            put == 204 and deleted == 204
            and anon[0][0] == 200 and anon[0][2] == small
            and [a[0] for a in anon[1:]] == [403, 403] and after[0] == 403)

        # 11. dst lost too; the heals.
        dst_digests = _part_digests(root, "dst")
        _wipe(root, "dst")
        state = phase("heal_bucket", lambda: _heal_bucket(c, "dst"))
        out["heal"] = {k: state[k] for k in ("Summary", "NumScanned",
                                             "NumHealed", "NumFailed")}
        checks["heal_bucket_ok"] = (state["Summary"] == "finished"
                                    and state["NumFailed"] == 0)
        ol = server.object_layer
        heals = phase("heal_versions", lambda: [
            ol.heal_object("ver", "big", vid) for vid in (v1, v2, marker)])
        checks["heal_versions_ok"] = all(len(h["healed"]) == len(S3_WIPED)
                                         for h in heals)
    finally:
        server.stop()
    checks["healed_identical"] = bool(ver_digests) and bool(dst_digests) \
        and all(p.is_file() and hashlib.sha256(p.read_bytes()).hexdigest()
                == h for p, h in {**ver_digests, **dst_digests}.items())
    survivor = next(i for i in range(1, 17) if i - 1 not in S3_WIPED)
    journal = _journal(root, survivor, "ver", "big")
    checks["healed_journals_ok"] = len(journal) == 3 and all(
        _journal(root, i + 1, "ver", "big") == journal for i in S3_WIPED)
    out["healed_files"] = len(ver_digests) + len(dst_digests)
    out["copy_bytes"] = {
        name: {"pulls": out["counters"][name]["copy_pulls"],
               "read": out["counters"][name]["copy_bytes"],
               "written": sum(p.stat().st_size for i in range(1, 17)
                              for p in (root / f"d{i}" / "dst").glob(
                                  f"{obj}/*/part.*"))}
        for name, obj in (("copy", "copy"), ("part_copy", "parts"))}
    out["checks"] = checks
    return out


def _wait_for(cond, timeout_s: float, what: str, poll_s: float = 0.005):
    """Poll cond() until it is true; returns the monotonic time it first
    held. Raises TimeoutError after `timeout_s`."""
    deadline = time.monotonic() + timeout_s
    while True:
        now = time.monotonic()
        if cond():
            return now
        if now > deadline:
            raise TimeoutError(f"{what}: not within {timeout_s} s")
        time.sleep(poll_s)


def repairable_names(bucket: str, prefix: str, count: int, drive: int,
                     k: int, drives: int) -> list[str]:
    """The first `count` names prefix + "0", "1", ... whose shard on drive
    index `drive` is a data shard under their distribution: msr-pm's
    piggyback plans cover data shards only, so a heal of that drive alone
    takes the repair plane."""
    from .object.metadata import hash_order

    out, i = [], 0
    while len(out) < count:
        name = f"{prefix}{i}"
        if hash_order(f"{bucket}/{name}", drives)[drive] - 1 < k:
            out.append(name)
        i += 1
    return out


def _drive_files(root: Path, drive: str, buckets) -> dict:
    """SHA-256 of every file under `buckets` on drive directory `drive`,
    by path relative to the drive."""
    base = root / drive
    return {str(p.relative_to(base)): hashlib.sha256(p.read_bytes())
            .hexdigest()
            for b in buckets for p in sorted((base / b).rglob("*"))
            if p.is_file()}


def _journal_versions(path: Path) -> list:
    """(version id, mod time, delete marker, data dir, size) of each
    version in an xl.meta file."""
    return [(v["vid"], v["mt"], v["del"], v.get("dd"), v.get("size"))
            for v in XLMeta.from_bytes(path.read_bytes()).versions]


def _replace_drive(disk: LocalStorage, path: Path) -> None:
    """A replaced drive: an empty directory at the same mount point, the
    same LocalStorage object re-opened on it."""
    shutil.rmtree(path)
    disk.__init__(str(path), endpoint=disk.endpoint(), device=disk.device)


SELF_HEAL_OUTAGE = 3    # drive d3 goes offline during writes
SELF_HEAL_WIPED = 8     # drive d8 is replaced by an empty one
SELF_HEAL_OFFLINE = (1, 6, 13, 16)  # drives off for the check of d3's shards
SELF_HEAL_VERSIONED = ("ver", "doc")


def self_heal_names(big_count: int, msr_count: int, small_count: int):
    """The keys self_heal writes in S3_BUCKET: (dense, msr-pm, small,
    outage dense, outage msr-pm). The msr-pm ones are chosen so that the
    replaced drive holds a data shard of each (its repair plan exists)."""
    msr = repairable_names(S3_BUCKET, "msr/obj-", msr_count + 1,
                           SELF_HEAL_WIPED - 1, 12, 16)
    return ([f"big/obj-{i}" for i in range(big_count)], msr[:msr_count],
            s3_object_names(small_count)[2:], "outage/dense", msr[-1])


def self_heal(root, size: int, device="cuda", big_count: int = 6,
              msr_count: int = 2, small_count: int = 256,
              small_sizes=SMALL_SIZES, seed: int = 0) -> dict:
    """Drive the self-healing services of a running Server over HTTP: a
    Server over 16 fresh drive directories d1..d16 under `root` (one 12+4
    set, 1 MiB blocks) started whole (Server.start(): the MRF drain every
    5 s, the disk monitor every 1 s, the fresh-drive healer every 10 s,
    the scanner), a client signing with the port's api/sign.py, and:

    1. load: `big_count` objects of `size` bytes with no codec header
       (the server's choice), `msr_count` with x-mtpu-codec: msr-pm,
       `small_count` small ones (sizes cycling over `small_sizes`), and a
       versioned bucket whose key holds two versions and a delete marker;
    2. outage: drive d3 offline until the monitor's loop pulls it, two
       more objects of `size` (one msr-pm) PUT on the other 15 drives
       (queued in the MRF), d3 back: the monitor's reconnect drains the
       MRF. Then d3's shard of both is verified (verify_file), and with
       d1, d6, d13 and d16 offline, so that d3's shards are needed, both
       are read back exactly over HTTP;
    3. replacement: d8 emptied and re-opened while the server runs; the
       fresh-drive healer's loop reformats and sweeps it: every file
       hashed before is back, the tracker (healing.json) is gone, the
       msr-pm objects took the repair plane at its plan's ratio, and the
       pacer granted one token a heal, none at its deadline;
    4. the scanner, its loop stopped: one cycle whose per-bucket usage
       equals the admin datausage walk, a second that skips both
       unchanged buckets through the tracker, and the admin usage
       snapshot over HTTP.

    Returns seconds, counter deltas, the sweep's numbers and the checks,
    each True when it held."""
    from .background import healpace

    dev = resolve_device(device)
    root = Path(root)
    rng = np.random.default_rng(seed)
    bigs, msrs, smalls, outage_dense, outage_msr = self_heal_names(
        big_count, msr_count, small_count)
    payloads = {name: rng.bytes(size) for name in
                bigs + msrs + [outage_dense, outage_msr]}
    for i, name in enumerate(smalls):
        payloads[name] = rng.bytes(small_sizes[i % len(small_sizes)])
    versions = [rng.bytes(small_sizes[2 % len(small_sizes)]),
                rng.bytes(small_sizes[-1])]
    vbucket, vkey = SELF_HEAL_VERSIONED
    out: dict = {"size": size, "k": 12, "m": 4, "outage_drive":
                 f"d{SELF_HEAL_OUTAGE}", "wiped_drive": f"d{SELF_HEAL_WIPED}",
                 "offline_drives": [f"d{i}" for i in SELF_HEAL_OFFLINE],
                 "objects": {"dense": bigs, "msr-pm": msrs,
                             "small": len(smalls),
                             "outage": [outage_dense, outage_msr],
                             "versioned": f"{vbucket}/{vkey}"},
                 "seconds": {}, "counters": {}}
    phase = _phases(dev, out)
    checks: dict = {}
    server = Server([str(root / "d{1...16}")], port=0,
                    root_user=S3_ACCESS, root_password=S3_SECRET,
                    default_parity=4, device=dev).start()
    pool = server.object_layer.pools[0]
    es = pool.sets[0]
    drive = {n: pool.disks[n - 1] for n in range(1, 17)}  # d1..d16
    try:
        c = S3Client(server.endpoint, S3_ACCESS, S3_SECRET)
        b = f"/{S3_BUCKET}"
        msr_header = {"x-mtpu-codec": "msr-pm"}

        def put(name, headers=None) -> bool:
            status, h, _ = c.request("PUT", f"{b}/{name}", headers=headers,
                                     body=payloads[name])
            return status == 200 and h.get("ETag") == \
                f'"{hashlib.md5(payloads[name]).hexdigest()}"'

        def load() -> bool:
            ok = c.request("PUT", b)[0] == 200
            ok &= all(put(n) for n in bigs)
            ok &= all(put(n, msr_header) for n in msrs)
            ok &= all(put(n) for n in smalls)
            ok &= c.request("PUT", f"/{vbucket}")[0] == 200
            ok &= c.request("PUT", f"/{vbucket}", [("versioning", "")],
                            body=ENABLED_XML)[0] == 200
            for body in versions:
                ok &= c.request("PUT", f"/{vbucket}/{vkey}",
                                body=body)[0] == 200
            ok &= c.request("DELETE", f"/{vbucket}/{vkey}")[0] == 204
            return ok

        checks["load_ok"] = phase("load", load)
        out["codecs"] = {name: drive[1].read_version(
            S3_BUCKET, name).erasure.codec for name in bigs + msrs}
        checks["msr_stamped"] = all(out["codecs"][n] == "msr-pm"
                                    for n in msrs)

        # 2. The outage: the monitor's own loop pulls d3.
        slot = SELF_HEAL_OUTAGE - 1
        t0 = time.monotonic()
        drive[SELF_HEAL_OUTAGE].set_online(False)
        out["seconds"]["outage_pulled"] = _wait_for(
            lambda: es.disks[slot] is None, 10, "d3 pulled") - t0
        checks["outage_put_ok"] = phase("outage_put", lambda: put(
            outage_dense) and put(outage_msr, msr_header))
        queued = es.mrf_stats()["pending"]
        out["mrf_queued"] = queued
        checks["mrf_queued_ok"] = queued == 2
        healed0 = server.mrf.healed_total
        _sync(dev)
        before = counters()
        t_return = time.monotonic()
        drive[SELF_HEAL_OUTAGE].set_online(True)
        t_slot = _wait_for(lambda: es.disks[slot] is not None, 10,
                           "d3 reconnected")
        t_done = _wait_for(
            lambda: (es.mrf_stats()["pending"] == 0
                     and server.mrf.healed_total >= healed0 + queued),
            30, "MRF drained")
        _sync(dev)
        out["counters"]["mrf_drain"] = _delta(before, counters())
        out["seconds"]["return_to_empty_mrf"] = t_done - t_return
        out["seconds"]["reconnect"] = t_slot - t_return
        out["seconds"]["mrf_drain"] = t_done - t_slot

        def shard_verified(name) -> bool:
            fi = drive[SELF_HEAL_OUTAGE].read_version(S3_BUCKET, name)
            drive[SELF_HEAL_OUTAGE].verify_file(S3_BUCKET, name, fi)
            return True

        checks["outage_shards_verified"] = (
            shard_verified(outage_dense) and shard_verified(outage_msr))
        for n in SELF_HEAL_OFFLINE:
            drive[n].set_online(False)
        gets = phase("outage_degraded_get", lambda: [
            c.request("GET", f"{b}/{name}")
            for name in (outage_dense, outage_msr)])
        checks["outage_get_ok"] = all(
            status == 200 and body == payloads[name]
            for (status, _, body), name in zip(gets, (outage_dense,
                                                      outage_msr)))
        for n in SELF_HEAL_OFFLINE:
            drive[n].set_online(True)
        # Every drive back in its slot, and the MRF entries the degraded
        # GETs queued drained, before the replacement.
        _wait_for(lambda: all(d is not None for d in es.disks)
                  and es.mrf_stats()["pending"] == 0, 30,
                  "drives back and MRF empty")

        # 3. The replacement: d8 emptied while the server runs.
        wiped = f"d{SELF_HEAL_WIPED}"
        user = (S3_BUCKET, vbucket)
        originals = _drive_files(root, wiped, user)
        fmt = hashlib.sha256((root / wiped / ".mtpu.sys" / "format.json")
                             .read_bytes()).hexdigest()
        multi = f"{vbucket}/{vkey}/xl.meta"
        journal = _journal_versions(root / wiped / multi)
        n_versions = sum(len(server.object_layer.list_object_versions(
            bk, max_keys=100000).versions) for bk in user)
        pace0 = healpace.pacer().snapshot()
        repair0 = repair.stats_snapshot()
        _sync(dev)
        before = counters()
        t_wipe = time.monotonic()
        _replace_drive(drive[SELF_HEAL_WIPED], root / wiped)
        tracker = root / wiped / ".mtpu.sys" / "healing.json"
        t_tracker = _wait_for(tracker.is_file, 30, "healing.json written")
        endpoint = drive[SELF_HEAL_WIPED].endpoint()
        t_healed = _wait_for(
            lambda: endpoint in server.fresh_disk_healer.healed_disks, 120,
            f"{wiped} healed")
        _sync(dev)
        out["counters"]["sweep"] = _delta(before, counters())
        out["seconds"]["wipe_to_healed"] = t_healed - t_wipe
        out["seconds"]["detect"] = t_tracker - t_wipe
        out["seconds"]["sweep"] = t_healed - t_tracker
        healed_files = _drive_files(root, wiped, user)
        pace1 = healpace.pacer().snapshot()
        repair1 = repair.stats_snapshot()
        rep = {k: repair1[k] - repair0[k] for k in repair1}
        part_bytes = sum((root / wiped / p).stat().st_size
                         for p in healed_files
                         if p.rsplit("/", 1)[-1].startswith("part."))
        out["sweep"] = {
            "versions_healed": n_versions,
            "part_bytes_rebuilt": part_bytes,
            "part_bytes_per_s": part_bytes / out["seconds"]["sweep"],
            "repair": {**rep, "bytes_read_per_byte_healed": (
                rep["bytes_read"] / rep["bytes_written"]
                if rep["bytes_written"] else None)},
            "pacer": pace1,
            "pacer_grants": pace1["grants_total"] - pace0["grants_total"],
            "pacer_deadline_grants": (pace1["deadline_grants_total"]
                                      - pace0["deadline_grants_total"]),
        }
        # Every file back equal, but the versioned key's journal: a heal
        # writes each version's is-latest flag as it reads it, and the
        # delete marker's erasure stamp from the version it copies, so
        # its bytes differ from the survivors' (minio_tpu's heal does the
        # same); its versions must be the same.
        out["sweep"]["files_differing"] = sorted(
            p for p in originals if healed_files.get(p) != originals[p])
        checks["files_restored"] = (
            set(healed_files) == set(originals)
            and out["sweep"]["files_differing"] in ([], [multi]))
        checks["journal_versions_restored"] = (
            _journal_versions(root / wiped / multi) == journal)
        checks["format_restored"] = hashlib.sha256(
            (root / wiped / ".mtpu.sys" / "format.json").read_bytes()
        ).hexdigest() == fmt
        checks["tracker_removed"] = not tracker.exists()
        ratio = out["sweep"]["repair"]["bytes_read_per_byte_healed"]
        # The repair plane serves every msr-pm object with part files
        # whose shard on the replaced drive has a plan (a data shard).
        out["sweep"]["repairable"] = sum(
            1 for name in bigs + msrs + smalls + [outage_dense, outage_msr]
            for fi in [drive[1].read_version(S3_BUCKET, name)]
            if fi.erasure.codec == "msr-pm" and fi.data_dir
            and fi.erasure.distribution[SELF_HEAL_WIPED - 1] - 1 < 12)
        checks["repair_plane_ok"] = (
            rep["parts_repaired"] == out["sweep"]["repairable"]
            >= msr_count + 1 and rep["fallbacks"] == 0 and ratio == 8.0)
        checks["pacer_one_grant_a_heal"] = (
            out["sweep"]["pacer_grants"] == n_versions
            and out["sweep"]["pacer_deadline_grants"] == 0)

        # 4. The scanner, its 60 s loop stopped so the cycles are ours.
        server.scanner.stop()
        checks["scanner_loop_stopped"] = not server.scanner._thread.is_alive()
        usage = phase("scan_cycle", server.scanner.scan_cycle)
        status, _, body = c.request("GET", "/minio/admin/v3/datausage")
        walk = json.loads(body)["bucketsUsage"] if status == 200 else {}
        checks["scan_equals_walk"] = bool(walk) and walk == {
            bk: {"objectsCount": u.objects_count, "size": u.objects_size}
            for bk, u in usage.buckets_usage.items()}
        phase("scan_cycle_2", server.scanner.scan_cycle)
        checks["second_cycle_skips"] = (
            server.scanner.buckets_skipped_last_cycle == len(walk))
        status, _, body = c.request("GET", "/minio/admin/v3/usage",
                                    [("histogram", "true")])
        snap = json.loads(body) if status == 200 else {}
        checks["usage_over_http"] = (
            status == 200
            and snap["objectsTotalCount"] == usage.objects_total_count
            and snap["objectsTotalSize"] == usage.objects_total_size
            and all("sizeHistogram" in v
                    for v in snap["bucketsUsage"].values()))
        out["usage"] = snap
        out["system_objects"] = {
            oi.name: oi.size for oi in server.object_layer.list_objects(
                ".minio.sys", max_keys=1000).objects}
    finally:
        server.stop()
    out["checks"] = checks
    return out


def object_self_heal(root, size: int, device="cuda", drives: int = 16,
                     parity: int = 4, seed: int = 0) -> dict:
    """The self-healing services on the object layer, called directly (no
    HTTP, no service loops): `drives` fresh drive directories d0.. under
    `root` as one set of parity `parity` (ErasureServerPools), and

    1. a dense and an msr-pm object of `size` bytes PUT;
    2. drive d1 offline, pulled by a DiskMonitor after two failed probes;
       a dense and an msr-pm object PUT on the rest (queued in the MRF);
       d1 back: the monitor's reconnect drains the MRF through an
       MRFHealer;
    3. drive d2 emptied and re-opened; FreshDiskHealer.check_once()
       reformats and sweeps it.

    The msr-pm objects' shards on d2 are data shards, so the sweep
    repairs them through the repair plane. Returns each step's seconds
    and counter deltas, the checks (d1 holds a verified shard of the
    outage objects; every file of d2 back equal; the tracker gone; the
    repair plane used with no fallback), and `files`: the SHA-256 of
    every file under the drives' bucket, by path, to compare runs."""
    from .background import DiskMonitor, FreshDiskHealer, MRFHealer
    from .object.pools import ErasureServerPools

    dev = resolve_device(device)
    root = Path(root)
    bucket = OBJECT_BUCKET
    k = drives - parity
    disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}", device=dev)
             for i in range(drives)]
    sets = ErasureSets(disks, drives, default_parity=parity, device=dev)
    sets.init_format()
    ol = ErasureServerPools([sets], device=dev)
    ol.make_bucket(bucket)
    es = sets.sets[0]
    rng = np.random.default_rng(seed)
    msr = repairable_names(bucket, "msr-", 2, 2, k, drives)
    names = {"dense-0": "dense-gf8", msr[0]: "msr-pm",
             "outage-dense": "dense-gf8", msr[1]: "msr-pm"}
    payloads = {n: rng.bytes(size) for n in names}
    out: dict = {"size": size, "k": k, "m": parity, "seconds": {},
                 "counters": {}}
    phase = _phases(dev, out)
    checks: dict = {}

    def put(name):
        ol.put_object(bucket, name, io.BytesIO(payloads[name]), size,
                      ObjectOptions(codec=names[name]))

    phase("put", lambda: [put(n) for n in ("dense-0", msr[0])])
    mrf = MRFHealer(ol)
    mon = DiskMonitor(ol, mrf_healer=mrf)
    disks[1].set_online(False)
    mon.check_once()
    checks["pulled"] = mon.check_once()["offline"] == ["d1"]
    phase("outage_put", lambda: [put(n) for n in ("outage-dense", msr[1])])
    checks["mrf_queued"] = es.mrf_stats()["pending"] == 2
    disks[1].set_online(True)
    res = phase("mrf_drain", mon.check_once)
    checks["reconnect_drained"] = (res["reconnected"] == ["d1"]
                                   and es.mrf_stats()["pending"] == 0
                                   and mrf.healed_total == 2)
    for n in ("outage-dense", msr[1]):
        disks[1].verify_file(bucket, n, disks[1].read_version(bucket, n))
    checks["outage_shards_verified"] = True

    originals = _drive_files(root, "d2", (bucket,))
    repair0 = repair.stats_snapshot()
    _replace_drive(disks[2], root / "d2")
    healer = FreshDiskHealer(ol)
    checks["swept"] = phase("sweep", healer.check_once) == ["d2"]
    rep = {key: v - repair0[key] for key, v in repair.stats_snapshot().items()}
    out["repair"] = rep
    checks["files_restored"] = _drive_files(root, "d2", (bucket,)) == \
        originals
    checks["tracker_removed"] = not (root / "d2" / ".mtpu.sys" /
                                     "healing.json").exists()
    checks["repair_plane_ok"] = (rep["parts_repaired"] == 2
                                 and rep["fallbacks"] == 0)
    checks["get_ok"] = all(ol.get_object_bytes(bucket, n) == payloads[n]
                           for n in names)
    out["files"] = {f"d{i}/{p}": h for i in range(drives)
                    for p, h in _drive_files(root, f"d{i}",
                                             (bucket,)).items()}
    ol.close()
    out["checks"] = checks
    return out


SSE_MODES = ("sse-s3", "sse-c", "sse-kms")
SSE_KMS_KEY = "smoke-kms-key"
SSE_C_KEY = bytes(range(32))
SSE_C_WRONG_KEY = bytes(range(1, 33))


def ssec_headers(key: bytes, copy_source: bool = False) -> dict:
    """The three SSE-C headers of `key` (the copy-source ones when
    `copy_source`)."""
    prefix = (ssemod.HDR_SSEC_COPY_PREFIX if copy_source
              else ssemod.HDR_SSEC_PREFIX)
    return {prefix + "algorithm": "AES256",
            prefix + "key": base64.b64encode(key).decode(),
            prefix + "key-md5": base64.b64encode(
                hashlib.md5(key).digest()).decode()}


def sse_put_headers(mode: str) -> dict:
    if mode == "sse-s3":
        return {ssemod.HDR_SSE: "AES256"}
    if mode == "sse-c":
        return ssec_headers(SSE_C_KEY)
    return {ssemod.HDR_SSE: "aws:kms", ssemod.HDR_SSE_KMS_ID: SSE_KMS_KEY,
            ssemod.HDR_SSE_KMS_CONTEXT: base64.b64encode(
                json.dumps({"bucket": S3_BUCKET}).encode()).decode()}


class _PayloadReader:
    """A file-like view of bytes, read in pieces (no copy of the whole)."""

    def __init__(self, data: bytes):
        self._view = memoryview(data)
        self._pos = 0

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = len(self._view) - self._pos
        out = self._view[self._pos:self._pos + n]
        self._pos += len(out)
        return bytes(out)


class _Compare:
    """A GET sink that holds the body to `want` piece by piece."""

    def __init__(self, want: bytes):
        self._want = memoryview(want)
        self._pos = 0
        self.equal = True

    def __call__(self, piece: bytes) -> None:
        end = self._pos + len(piece)
        if self._want[self._pos:end] != piece:
            self.equal = False
        self._pos = end

    @property
    def ok(self) -> bool:
        return self.equal and self._pos == len(self._want)


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


@contextlib.contextmanager
def _rss_peak(out: dict, name: str, period_s: float = 0.005):
    """Record under out[name] the peak resident set growth (bytes) of
    the process while the block runs, sampled every `period_s`."""
    base = _rss_bytes()
    peak = [base]
    done = threading.Event()

    def sample():
        while not done.wait(period_s):
            peak[0] = max(peak[0], _rss_bytes())

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield
    finally:
        done.set()
        t.join()
        out[name] = max(peak[0], _rss_bytes()) - base


def _object_files(root: Path, bucket: str, name: str) -> dict:
    """SHA-256 of the object's xl.meta and part files on the 16 drives."""
    return {str(p.relative_to(root)): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for i in range(1, 17)
        for p in sorted((root / f"d{i}" / bucket / name).rglob("*"))
        if p.is_file()}


@contextlib.contextmanager
def _insecure_ssec():
    """MTPU_ALLOW_INSECURE_SSEC=1 for the block: the port serves no TLS."""
    old = os.environ.get("MTPU_ALLOW_INSECURE_SSEC")
    os.environ["MTPU_ALLOW_INSECURE_SSEC"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MTPU_ALLOW_INSECURE_SSEC", None)
        else:
            os.environ["MTPU_ALLOW_INSECURE_SSEC"] = old


def sse_range(size: int) -> tuple[int, int]:
    """The ranged GET's window: from 7 bytes before the middle package
    boundary, across 48 packages and one erasure block boundary, within
    the object."""
    ps = ssemod.PACKAGE_SIZE
    first = max(0, (size // 2) // ps * ps - 7)
    return first, min(size - first, 48 * ps + 13)


def s3_sse(root, size: int, device="cuda", modes=SSE_MODES,
           seed: int = 50) -> dict:
    """Drive server-side encryption over HTTP on localhost: a Server over
    16 fresh drive directories under `root` (one 12+4 set), its S3 plane
    alone, MTPU_ALLOW_INSECURE_SSEC=1 while it runs (the port has no
    TLS). A KMS key is made through the admin route; then for each mode
    of `modes` (sse-s3, sse-c, sse-kms), on its own seeded `size`-byte
    object:

    1. PUT streamed from the client in 1 MiB pieces; the stored size in
       xl.meta must be ssemod.encrypted_size(size);
    2. GET, and a ranged GET across package and block boundaries, each
       body held to the payload piece by piece;
    3. HEAD with the mode's SSE answers and the logical size;
    4. the object lost on drives 0, 5, 12 and 15, a degraded GET;
    5. HealObject, after which every xl.meta and part file of the 16
       drives equals its original by SHA-256 (the heal never decrypts);
    6. a GET again.

    Then a CopyObject of the sse-c object to an SSE-S3 destination (a
    decrypt and a re-encrypt) with a GET of the copy, and a GET of the
    sse-c object with a wrong key (AccessDenied). Returns each step's
    seconds and counter deltas ("{mode}:{step}"), the peak growth of the
    process's resident set in each PUT and GET, and the checks."""
    dev = resolve_device(device)
    root = Path(root)
    out: dict = {"size": size, "k": 12, "m": 4, "modes": list(modes),
                 "wiped_drives": list(S3_WIPED), "seconds": {},
                 "counters": {}, "rss_peak_bytes": {},
                 "stored_size": ssemod.encrypted_size(size),
                 "packages": max(1, -(-size // ssemod.PACKAGE_SIZE))}
    phase = _phases(dev, out)
    checks: dict = {}
    payloads = {m: np.random.default_rng(seed + i).bytes(size)
                for i, m in enumerate(modes)}
    first, length = sse_range(size)
    out["range"] = [first, length]
    with _insecure_ssec():
        server = Server([str(root / "d{1...16}")], port=0,
                        root_user=S3_ACCESS, root_password=S3_SECRET,
                        default_parity=4, device=dev)
        # The S3 plane alone, as in s3_put_get_heal: the background
        # services would heal the lost drives on their own.
        server.s3.start()
        try:
            c = S3Client(server.endpoint, S3_ACCESS, S3_SECRET)
            checks["make_bucket_ok"] = c.request(
                "PUT", f"/{S3_BUCKET}")[0] == 200
            if "sse-kms" in modes:
                checks["kms_key_ok"] = c.request(
                    "POST", "/minio/admin/v3/kms/key/create",
                    [("key-id", SSE_KMS_KEY)])[0] == 200
            for mode in modes:
                _sse_object(c, server, root, mode, payloads[mode], phase,
                            out, checks, first, length)
            if "sse-c" in modes:
                _sse_copy_and_wrong_key(c, payloads["sse-c"], phase, out,
                                        checks)
        finally:
            server.stop()
    out["checks"] = checks
    return out


def _sse_get(c: S3Client, key: str, want: bytes, headers=None, query=None):
    cmp = _Compare(want)
    status, h, _ = c.get_stream(key, cmp, query, headers)
    return status, h, cmp.ok


def _sse_object(c, server, root: Path, mode: str, payload: bytes, phase,
                out: dict, checks: dict, first: int, length: int) -> None:
    """Steps 1-6 of s3_sse for one mode."""
    name = f"sse/{mode}.bin"
    key = f"/{S3_BUCKET}/{name}"
    get_headers = ssec_headers(SSE_C_KEY) if mode == "sse-c" else {}
    want_resp = {"sse-s3": {ssemod.HDR_SSE: "AES256"},
                 "sse-c": {ssemod.HDR_SSEC_ALGO: "AES256"},
                 "sse-kms": {ssemod.HDR_SSE: "aws:kms",
                             ssemod.HDR_SSE_KMS_ID: SSE_KMS_KEY}}[mode]

    def has_sse(h: dict) -> bool:
        lower = {k.lower(): v for k, v in h.items()}
        return all(lower.get(k) == v for k, v in want_resp.items())

    with _rss_peak(out["rss_peak_bytes"], f"{mode}:put"):
        status, h, _ = phase(f"{mode}:put", lambda: c.put_stream(
            key, _PayloadReader(payload), len(payload),
            sse_put_headers(mode)))
    checks[f"{mode}:put_ok"] = status == 200 and has_sse(h)
    fi = LocalStorage(str(root / "d1"), device=server.device).read_version(
        S3_BUCKET, name)
    checks[f"{mode}:stored_size_ok"] = (
        fi.size == ssemod.encrypted_size(len(payload))
        and fi.metadata.get(ssemod.META_ACTUAL_SIZE) == str(len(payload)))
    with _rss_peak(out["rss_peak_bytes"], f"{mode}:get"):
        status, h, ok = phase(f"{mode}:get", lambda: _sse_get(
            c, key, payload, get_headers))
    checks[f"{mode}:get_ok"] = status == 200 and ok and has_sse(h)
    rng = dict(get_headers, Range=f"bytes={first}-{first + length - 1}")
    status, h, ok = phase(f"{mode}:range_get", lambda: _sse_get(
        c, key, payload[first:first + length], rng))
    checks[f"{mode}:range_get_ok"] = status == 206 and ok and h.get(
        "Content-Range") == (f"bytes {first}-{first + length - 1}/"
                             f"{len(payload)}")
    status, h, _ = phase(f"{mode}:head", lambda: c.request(
        "HEAD", key, headers=get_headers))
    checks[f"{mode}:head_ok"] = (status == 200 and has_sse(h) and h.get(
        "Content-Length") == str(len(payload)))
    originals = _object_files(root, S3_BUCKET, name)
    for i in S3_WIPED:
        shutil.rmtree(root / f"d{i + 1}" / S3_BUCKET / name)
    status, _, ok = phase(f"{mode}:degraded_get", lambda: _sse_get(
        c, key, payload, get_headers))
    checks[f"{mode}:degraded_get_ok"] = status == 200 and ok
    healed = phase(f"{mode}:heal", lambda: server.object_layer.heal_object(
        S3_BUCKET, name))
    checks[f"{mode}:heal_ok"] = len(healed["healed"]) == len(S3_WIPED)
    checks[f"{mode}:healed_identical"] = bool(originals) and _object_files(
        root, S3_BUCKET, name) == originals
    status, _, ok = phase(f"{mode}:get_after_heal", lambda: _sse_get(
        c, key, payload, get_headers))
    checks[f"{mode}:get_after_heal_ok"] = status == 200 and ok


def _sse_copy_and_wrong_key(c, payload: bytes, phase, out: dict,
                            checks: dict) -> None:
    """The SSE-C object copied to an SSE-S3 destination, a GET of the
    copy, and a GET with the wrong SSE-C key."""
    src, dst = f"/{S3_BUCKET}/sse/sse-c.bin", f"/{S3_BUCKET}/sse/copy.bin"
    headers = {"x-amz-copy-source": src, ssemod.HDR_SSE: "AES256",
               **ssec_headers(SSE_C_KEY, copy_source=True)}
    status, h, _ = phase("copy_ssec_to_sses3", lambda: c.request(
        "PUT", dst, headers=headers))
    checks["copy_ok"] = status == 200 and h.get(ssemod.HDR_SSE) == "AES256"
    status, h, ok = phase("get_copy", lambda: _sse_get(c, dst, payload))
    checks["get_copy_ok"] = status == 200 and ok and h.get(
        ssemod.HDR_SSE) == "AES256"
    status, _, body = phase("wrong_key_get", lambda: c.request(
        "GET", src, headers=ssec_headers(SSE_C_WRONG_KEY)))
    checks["wrong_key_denied"] = status == 403 and b"AccessDenied" in body

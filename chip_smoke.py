"""Smoke run of minio_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught):
 1. the card's name and power limit, the torch and CUDA versions;
 2. build both kernels from minio_tpu_torch/csrc with nvcc for sm_90a and
    print ptxas's register/shared-memory report;
 3. hold each kernel against its plain PyTorch version on the card, with
    exact equality, tolerance 0 (integer arithmetic; the plain GF
    version's float32 matmul is exact with TF32 off): kernel A at every
    shard length the main paths give it (a full block's and each
    object's ragged last block's, path_shard_lengths()) for the encode
    and each reconstruction those paths run (path_reconstructions()), at
    wide geometries (40+40, 128+128, 200+56) and at S = 1, 2, 3 mod 16;
    for phase 4h's cells (check_codec_kernels) at each codec's shard
    lengths in the sub-shard view [B, k*alpha, S/alpha], its encode, its
    degraded GETs' and heal's reconstructions and its repair matrix, and
    at the widest msr-pm geometries (254+2, 128+128, 200+56 piggyback;
    8+2, 6+3, 5+5 coupled-layer); kernel B also at 4h's new chunk
    lengths (hash, grouped verify at k and k+m readers); for phase 4j
    (check_self_heal_kernels and path_reconstructions) the one-target
    heal of each of the 16 shards and the degraded GETs of its outage
    objects, under dense-gf8, cauchy-xor and msr-pm (the server picks the
    codec of objects sent with no header), and msr-pm 12+4's repair
    matrix of every shard that has one, at the shard lengths of its
    objects;
    kernel B on contiguous rows and on framed buffers at pitch 32 + L for
    the same shard lengths and short ones, at chunk starts 0..15 mod 16,
    its verify entry on good and corrupted frames, and its grouped verify
    entry at every path shard length (fetches of 8 frames from 12 and
    from 16 readers in one launch, a short last chunk in a second, bad
    first and last chunks in several groups);
 4. the main path: put_get_heal at 12+4 with 1 MiB blocks over a
    256 MiB + 12,345 B object, on the pipelined drivers (this host has
    more than one core): PUT, healthy GET, shards 0, 5, 12 and 15 lost,
    degraded GET (whole and ranged), heal, re-verify. The kernel launch
    counters are zeroed just before and read just after, and each of the
    PUT, degraded GET and heal phases must launch both kernels; every
    reader fetch with full-size chunks makes one grouped verify launch,
    no read is hedged, and the PUT's and GETs' copies to the card are
    pinned;
 4b. a traced (torch.profiler) run of the same path at 64 MiB + 12,345 B:
    device busy share and device time by kernel (4d: the same for the
    object layer of 4c);
 4c. the object layer: object_put_get_heal over 16 drive directories as
    one 12+4 set (ErasureSets -> ErasureObjects -> LocalStorage with
    xl.meta) with a 256 MiB + 12,345 B object and a 100 KiB inline one:
    PutObject, healthy GetObject, the losses of phase 4 mapped to drives
    through the object's distribution, degraded GetObject (whole and
    ranged), HealObject (rebuilt part.1 and xl.meta equal to the
    originals by SHA-256, verify_file on all 16 drives), one flipped
    byte (GET exact, verify_file raises). Counters zeroed just before and
    read just after; the healthy GETs and the verify_file scans must
    launch kernel B and no kernel A, PUT, degraded and ranged GET, heal
    and the GET past the flipped byte both. Prints {"object_layer": ...}
    with each phase's seconds and launches;
 4e. the S3 plane over HTTP on localhost: s3_put_get_heal starts the
    port's Server (boot self-tests on the card, 16 drive directories,
    one 12+4 set, 1 MiB blocks) and, signing with the port's
    api/sign.py, PUTs a 256 MiB + 12,345 B object aws-chunked, uploads
    8 x 16 MiB + 12,345 B in parts, PUTs 256 small objects (1 KiB,
    4 KiB + 1, 33 KiB, 100 KiB) under 4 prefixes, lists them with
    ListObjectsV2 in pages of 100 with and without a delimiter, GETs the
    big object whole and ranged, then 4 GETs at once (bytes only), loses
    every object on drives 0, 5, 12 and 15, GETs both big objects
    degraded and runs an admin heal of the bucket to its end (every
    rebuilt part.N and xl.meta equal to the original by SHA-256).
    Counters zeroed just before and read just after; each serial phase
    must launch what it runs (both kernels to write, rebuild or decode
    degraded; kernel B alone for a healthy GET; none to list). Prints
    {"s3_plane": ...} with each serial phase's seconds and launches; 4f
    traces it at 64 MiB + 12,345 B. No read of 4c or 4e is hedged;
 4g. serial against pipelined drivers: phase 4's path three times through
    each (utils.fanout.SINGLE_CORE set True, then False, in turns): shard
    files byte-identical between the two, GET bytes exact, and each
    phase's seconds as min of 3 with the spread; one traced run of each
    at 64 MiB + 12,345 B for its device-idle share and its copies to the
    card by kind (pageable or pinned); kernel B's verify launches per
    reader fetch, hedged reads, and each pipeline stage's busy, starved
    and stalled seconds. Prints {"pipelined": ...}, with the collector
    passes over 20 ms of phases 4 to 4g and the hedge windows restarted
    in each (garbage is collected before each run, the heap not frozen);
 4h. the codecs through the object layer (object_codec_put_get_heal, 1
    MiB blocks, 256 MiB + 12,345 B): cauchy-xor at 12+4 (16 drives),
    msr-pm at 12+4 (piggyback, alpha 2) and at 4+4 (8 drives,
    coupled-layer, alpha 16): PutObject with the codec, GET, m shards
    lost (0, 5, 12, 15; at 4+4 0, 3, 4, 7), degraded GET whole and
    ranged, HealObject (rebuilt files equal to the originals by
    SHA-256); in the msr-pm cells one more lost drive healed through the
    repair plane, with no fallback and bytes read a byte healed equal to
    the plan's ratio. Then one signed 16 MiB + 12,345 B PUT with
    x-mtpu-codec: msr-pm through the port's S3Server (s3_codec_put_get),
    GET back, xl.meta naming msr-pm on every drive. Counters zeroed just
    before and read just after each; kernel A launches in every phase
    but the healthy GETs, kernel B in all. Prints {"codecs": ...};
 4i. the S3 object core over HTTP (s3_core, a port Server on 16 drive
    directories, one 12+4 set, 1 MiB blocks, dense-gf8, objects of
    256 MiB + 12,345 B): versioning Enabled, two versions of ver/big (the
    second with x-amz-tagging), ListObjectVersions, a delete marker (GET
    404), GETs of both versions by id, ver's objects lost on drives 0, 5,
    12 and 15, a degraded GET of v1, CopyObject of v1 to dst/copy from the
    degraded source (257 ranged GETs of 1 MiB), three UploadPartCopy parts
    of v2 (the last two ragged: 7 B and 12,338 B tails), a REPLACE
    self-copy that moves no byte, tagging of v1, 256 small PUTs deleted by
    one POST ?delete (ListObjectsV2 empty, 512 versions listed in pages),
    a bucket policy with anonymous GETs and PUT, then dst lost on the same
    drives, an admin heal of dst and heal_object of v1, v2 and the marker
    (every part file equal to its pre-loss copy by SHA-256, every healed
    journal equal to a survivor's). Counters zeroed just before and read
    just after; kernel A launches in the degraded GET, the copies (at
    least once a pull: the source is degraded) and the heals, neither
    kernel in the self-copy. Prints {"s3_core": ...} with each step's
    seconds and launches and the bytes each copy read and wrote;
 4j. the self-healing services of a running server (entry.self_heal): a
    Server over 16 drive directories (one 12+4 set, 1 MiB blocks)
    started whole, so its own loops run (the MRF drain every 5 s, the
    disk monitor every 1 s, the fresh-drive healer every 10 s, the
    scanner). Over HTTP: 6 objects of 256 MiB + 12,345 B with no codec
    header, 2 with x-mtpu-codec: msr-pm, the 256 small objects of 4e, a
    versioned key with two versions and a delete marker. Drive d3
    offline until the monitor pulls it, two more objects (one msr-pm) PUT
    on 15 drives and queued in the MRF, d3 back: the seconds from its
    return to an empty MRF, d3's shards verified, and both objects read
    exactly with d1, d6, d13 and d16 offline. Then d8 emptied while the
    server runs: the fresh-drive healer's loop reformats and sweeps it
    (seconds from the wipe, the sweep's own seconds, versions healed,
    part-file bytes rebuilt, the repair plane's STATS at 8.0 bytes read a
    byte healed with no fallback, the pacer's grants, one a heal), every
    file of d8 back. Two scanner cycles (its loop stopped): usage equal
    to the admin datausage walk, the second skipping both buckets through
    the update tracker, the admin usage snapshot over HTTP. Kernel A's
    wrapper also counts its launches by shape. Prints {"self_heal": ...};
    one traced run (object_self_heal at 64 MiB + 12,345 B) gives the idle
    share. 3b: kernel A and B at the shard lengths of the objects the
    server wrote under .minio.sys, known only after the run;
 5. time each kernel at the main shapes with CUDA events (kernel B cold
    at the PUT shape [128, 87382] and L2-warm at the GET shape
    [8, 87382], in ns per packet too, and its grouped verify at a fetch
    of 12 readers x 8 frames; kernel A also at 4h's msr-pm encode
    shapes [8, 24, 43,691] -> 8 and [8, 64, 16,384] -> 64, and at 4j's
    heal shapes, the one-target reconstruction [8, 12, 87,382] -> 1 and
    the msr-pm repair window [5, 16, 43,691] -> 2) and print one JSON line
    {"kernels": [...]}, whose launches are those of phases 4, 4c, 4e, 4h,
    4i and 4j (by path in "launches_by_path");
 6. print the device JSON as the last line.

It exits non-zero without a result when no CUDA card is available.
"""

from __future__ import annotations

import gc
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OBJECT_SIZE = (256 << 20) + 12_345
TRACE_SIZE = (64 << 20) + 12_345
INLINE_SIZE = 100 << 10
# Phase 4e: multipart parts (minio-go's 16 MiB part size) and the small
# objects' sizes.
MP_PART, MP_PARTS, MP_LAST = 16 << 20, 8, 12_345
SMALL_SIZES = (1 << 10, (4 << 10) + 1, 33 << 10, 100 << 10)
SMALL_COUNT = 256
K, M, BLOCK = 12, 4, 1 << 20
SHARD = -(-BLOCK // K)  # 87,382
BATCH = 8
LOST = (0, 5, 12, 15)
HASH_LENGTHS = (0, 1, 17, 31, 32, 33, 63, 4096 + 22)
# Phase 4h: (codec, drives, lost shards, repair target) of each cell, one
# set of parity 4 each: 16 drives at 12+4 and 8 drives at 4+4, MinIO's
# EC:4 sets. The repair target of the piggyback cell is a data shard (its
# plans cover data shards only).
CODEC_CELLS = (("cauchy-xor", 16, LOST, None),
               ("msr-pm", 16, LOST, 3),
               ("msr-pm", 8, (0, 3, 4, 7), 6))
CODEC_PARITY = 4
S3_CODEC_SIZE = (16 << 20) + 12_345
# The widest msr-pm geometries the registry admits: piggyback (alpha 2)
# at the widest K (254+2), R (128+128) and both (200+56); coupled-layer
# at alpha 32, 27 and 25.
WIDE_MSR = ((254, 2), (128, 128), (200, 56), (8, 2), (6, 3), (5, 5))
# Phase 4i: the small objects put and deleted in the versioned bucket,
# and the objects its heals rebuild (bucket, key).
CORE_SMALL_COUNT, CORE_SMALL_SIZE = 256, 1 << 10
CORE_OBJECTS = (("ver", "big"), ("dst", "copy"), ("dst", "parts"),
                ("dst", "public/x"))
# Phase 4j: the self-healing services of a running Server (entry.self_heal).
SELF_HEAL_CODECS = ("dense-gf8", "cauchy-xor", "msr-pm")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rand(shape, rng) -> torch.Tensor:
    return torch.from_numpy(
        rng.integers(0, 256, size=shape, dtype=np.uint8)).cuda()


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max())


def path_shard_lengths() -> list[int]:
    """The shard lengths the main paths give the kernels: a full block's,
    and the ragged last block's of each object or part that phases 4,
    4b, 4c, 4d, 4e, 4f and 4i store (an inline or small object is one
    short block; 4i's UploadPartCopy parts end in 7 B and 12,338 B)."""
    from minio_tpu_torch.entry import part_copy_ranges

    core_parts = [last - first + 1
                  for first, last in part_copy_ranges(OBJECT_SIZE)]
    lengths = set()
    for size in (OBJECT_SIZE, TRACE_SIZE, INLINE_SIZE, MP_PART, MP_LAST,
                 *SMALL_SIZES, *core_parts, CORE_SMALL_SIZE):
        if size >= BLOCK:
            lengths.add(SHARD)
        if size % BLOCK:
            lengths.add(-(-(size % BLOCK) // K))
    return sorted(lengths)


def path_reconstructions() -> list[tuple[tuple, tuple]]:
    """(unavailable shards, rebuilt shards) of every reconstruction the
    main paths run: phase 4's and 4c's heal (shards 0, 5, 12, 15 lost),
    degraded GET (data shards 0 and 5 rebuilt, shard 12 gone) and GET
    past a flipped byte (data shard 3 rebuilt); and phases 4e's and 4i's,
    whose lost shards are those that drives 0, 5, 12 and 15 hold for each
    object, through its distribution: the heal rebuilds them all, a
    degraded GET (4e's big objects, and 4i's versions of ver/big and the
    copies' pulls from them) the data shards among them."""
    from minio_tpu_torch.entry import S3_BUCKET, S3_WIPED, s3_object_names
    from minio_tpu_torch.object.metadata import hash_order

    recs = {(LOST, LOST), (LOST, (0, 5)), ((3,), (3,))}
    keys = [(f"{S3_BUCKET}/{name}", n < 2)
            for n, name in enumerate(s3_object_names(SMALL_COUNT))]
    keys += [(f"{b}/{name}", b == "ver") for b, name in CORE_OBJECTS]
    for key, read_degraded in keys:
        dist = hash_order(key, K + M)
        lost = tuple(sorted(dist[d] - 1 for d in S3_WIPED))
        recs.add((lost, lost))
        data_lost = tuple(s for s in lost if s < K)
        if read_degraded and data_lost:
            recs.add((lost, data_lost))
    return sorted(recs | set(self_heal_reconstructions()))


def self_heal_reconstructions() -> list[tuple[tuple, tuple]]:
    """(unavailable, rebuilt) of phase 4j's reconstructions, under any
    codec: the one-target heal of each of the 16 shards (the MRF drain
    rebuilds the shard of d3, the sweep that of d8, which an object's
    distribution decides), and the degraded GETs of the two outage
    objects with d1, d6, d13 and d16 offline (their data shards among
    those drives' rebuilt)."""
    from minio_tpu_torch.entry import (S3_BUCKET, SELF_HEAL_OFFLINE,
                                       self_heal_names)
    from minio_tpu_torch.object.metadata import hash_order

    recs = [((t,), (t,)) for t in range(K + M)]
    *_, outage_dense, outage_msr = self_heal_names(6, 2, SMALL_COUNT)
    for name in (outage_dense, outage_msr):
        dist = hash_order(f"{S3_BUCKET}/{name}", K + M)
        lost = tuple(sorted(dist[d - 1] - 1 for d in SELF_HEAL_OFFLINE))
        data_lost = tuple(s for s in lost if s < K)
        if data_lost:
            recs.append((lost, data_lost))
    return recs


def codec_cell(cell):
    """(codec, k, m, lost, repair target, the cell's Erasure on the card)
    of a phase 4h cell."""
    from minio_tpu_torch.erasure.codec import cached_erasure

    codec, drives, lost, target = cell
    k, m = drives - CODEC_PARITY, CODEC_PARITY
    return codec, k, m, lost, target, cached_erasure(k, m, BLOCK, codec,
                                                     "cuda")


def codec_shard_lengths(erasure) -> list[int]:
    """The shard lengths phase 4h gives the kernels in a cell: a full
    block's and the last block's of its 256 MiB + 12,345 B object (and of
    the 16 MiB + 12,345 B S3 PUT), rounded to the codec's
    sub-packetization."""
    return sorted({erasure.shard_size()} | {
        erasure.chunk_size(size % BLOCK)
        for size in (OBJECT_SIZE, S3_CODEC_SIZE) if size % BLOCK})


def codec_reconstructions(k: int, lost) -> list[tuple[tuple, tuple]]:
    """(unavailable, rebuilt) of a cell's degraded GETs (its lost data
    shards) and heal (every lost shard)."""
    lost = tuple(lost)
    return [(lost, tuple(s for s in lost if s < k)), (lost, lost)]


def codec_chunk_lengths() -> dict:
    """Kernel B's chunk lengths in phase 4h that no earlier phase has,
    each with the (k, m) of a cell that gives it."""
    out = {}
    for cell in CODEC_CELLS:
        _, k, m, _, _, erasure = codec_cell(cell)
        for s in codec_shard_lengths(erasure):
            if s not in path_shard_lengths():
                out.setdefault(s, (k, m))
    return dict(sorted(out.items()))


def check_codec_kernels(rng, errs: dict) -> None:
    """Phase 3 for phase 4h: kernel A against its plain version at every
    matrix and shape the codec cells give it (each codec's encode, the
    degraded GETs' and heals' reconstructions, in the sub-shard view
    [B, k*alpha, S/alpha]; the repair matrices [alpha, T] on
    [nb, T, S/alpha]), at the widest msr-pm geometries, and kernel B at
    the cells' new chunk lengths."""
    from minio_tpu_torch.erasure import registry, repair
    from minio_tpu_torch.ops import highwayhash_torch as hh, regen

    def gf_err(mat, shapes) -> int:
        return gf_matrix_err(rng, errs, mat, shapes)

    for cell in CODEC_CELLS:
        codec, k, m, lost, target, erasure = codec_cell(cell)
        entry = registry.get(codec)
        a = erasure.subshards
        lengths = codec_shard_lengths(erasure)
        mats = [("encode", entry.parity_matrix(k, m))]
        for unavailable, targets in codec_reconstructions(k, lost):
            present = [i for i in range(k + m) if i not in unavailable]
            mats.append((f"reconstruct {targets} from {present[:k]}",
                         entry.reconstruct_matrix(k, m, present,
                                                  list(targets))))
        shapes = [(b, k * a, s // a) for s in lengths for b in (1, BATCH)]
        for name, mat in mats:
            err = gf_err(mat, shapes)
            log(f"gf_apply {codec} {k}+{m} {name} -> {mat.shape[0]} rows "
                f"at [B, {k * a}, S/{a}] for B in (1, {BATCH}), S in "
                f"{lengths}: max_abs_err {err}")
        if target is not None:
            plan = entry.repair_plan(k, m, target)
            step = max(1, repair._WINDOW_BYTES // (
                plan.total_symbols * (erasure.shard_size() // a)))
            shapes = [(nb, plan.total_symbols, s // a) for s in lengths
                      for nb in (1, step)]
            err = gf_err(plan.matrix, shapes)
            log(f"gf_apply {codec} {k}+{m} repair of shard {target} "
                f"[{plan.alpha}, {plan.total_symbols}] at {shapes}: "
                f"max_abs_err {err}")
    for k, m in WIDE_MSR:
        entry = registry.get("msr-pm")
        t0 = time.perf_counter()
        a = entry.alpha(k, m)  # builds and verifies the geometry
        built = time.perf_counter() - t0
        sub = 515
        enc = gf_err(entry.parity_matrix(k, m), [(2, k * a, sub)])
        lost = list(range(m))
        rec = gf_err(entry.reconstruct_matrix(
            k, m, list(range(m, k + m)), lost), [(2, k * a, sub)])
        log(f"gf_apply msr-pm {k}+{m} ({regen.arm(k, m)}, alpha {a}, "
            f"built in {built:.1f} s): encode [2, {k * a}, {sub}] -> "
            f"{m * a} rows max_abs_err {enc}; reconstruct of shards "
            f"0..{m - 1} -> {m * a} rows max_abs_err {rec}")
    for s, (k, m) in codec_chunk_lengths().items():
        x = rand((BATCH * (k + m), s), rng)
        got = hh.hash256_batch(x)
        want = hh._hash256_plain(x, hh.MAGIC_KEY)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs["highwayhash256"] = max(errs["highwayhash256"], err)
        log(f"highwayhash256 hash256_batch {tuple(x.shape)}: "
            f"max_abs_err {err}")
        for groups in (k, k + m):
            err = grouped_verify_case(rng, groups, BATCH, s)
            errs["hh256_verify_grouped"] = max(errs["hh256_verify_grouped"],
                                               err)


def gf_matrix_err(rng, errs: dict, mat, shapes) -> int:
    """Kernel A against its plain version with GF matrix `mat` on random
    shards of each shape; the max abs difference, also kept in errs."""
    from minio_tpu_torch.ops import gf, rs, rs_cuda

    bm = gf.to_device_bitmat(gf.bit_matrix(mat), "cuda")
    err = 0
    for shape in shapes:
        x = rand(shape, rng)
        got = rs_cuda.apply_gf_matrix_cuda(bm, x)
        want = rs._apply_bits_plain(bm, x)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
    errs["gf_apply"] = max(errs["gf_apply"], err)
    return err


def self_heal_lengths(erasure) -> list[int]:
    """The shard lengths phase 4j gives the kernels under a codec: a full
    block's and the last block's of its objects (256 MiB + 12,345 B and
    the small sizes), in the codec's rounding."""
    return sorted({erasure.shard_size()} | {
        erasure.chunk_size(size % BLOCK)
        for size in (OBJECT_SIZE, *SMALL_SIZES) if size % BLOCK})


def check_self_heal_kernels(rng, errs: dict) -> None:
    """Phase 3 for phase 4j under the codecs its objects may carry (the
    server picks one for the objects with no codec header; msr-pm on the
    others): kernel A at each of self_heal_reconstructions() under
    cauchy-xor and msr-pm (dense-gf8's are in path_reconstructions()),
    in the codec's view [B, k*alpha, S/alpha], and at msr-pm 12+4's
    repair matrix of every shard that has one, on [nb, T, S/alpha] as
    the repair plane windows it."""
    from minio_tpu_torch.erasure import registry, repair
    from minio_tpu_torch.erasure.codec import cached_erasure

    for codec in SELF_HEAL_CODECS[1:]:
        entry = registry.get(codec)
        erasure = cached_erasure(K, M, BLOCK, codec, "cuda")
        a = erasure.subshards
        lengths = self_heal_lengths(erasure)
        shapes = [(b, K * a, ln // a) for ln in lengths for b in (1, BATCH)]
        for unavailable, targets in self_heal_reconstructions():
            present = [i for i in range(K + M) if i not in unavailable]
            mat = entry.reconstruct_matrix(K, M, present, list(targets))
            err = gf_matrix_err(rng, errs, mat, shapes)
            log(f"gf_apply {codec} {K}+{M} reconstruct {targets} from "
                f"{present[:K]} -> {mat.shape[0]} rows at [B, {K * a}, "
                f"S/{a}] for B in (1, {BATCH}), S in {lengths}: "
                f"max_abs_err {err}")
        if entry.repair_plan is None:
            continue
        for target in range(K + M):
            plan = entry.repair_plan(K, M, target)
            if plan is None:
                log(f"gf_apply {codec} {K}+{M} repair of shard {target}: "
                    "no plan (the dense reconstruction heals it)")
                continue
            step = max(1, repair._WINDOW_BYTES // (
                plan.total_symbols * (erasure.shard_size() // a)))
            rshapes = [(nb, plan.total_symbols, ln // a) for ln in lengths
                       for nb in (1, step)]
            err = gf_matrix_err(rng, errs, plan.matrix, rshapes)
            log(f"gf_apply {codec} {K}+{M} repair of shard {target} "
                f"[{plan.alpha}, {plan.total_symbols}] at {rshapes}: "
                f"max_abs_err {err}")


def check_system_object_kernels(rng, errs: dict, sizes: dict) -> None:
    """Phase 3b, after phase 4j: the objects the server wrote under
    .minio.sys (the scanner's usage, the update tracker's filter, bucket
    metadata) have sizes known only after the run. Kernel A's encode
    under dense-gf8 and cauchy-xor, and kernel B's hash and grouped
    verify, at their shard lengths, exact."""
    from minio_tpu_torch.erasure import registry
    from minio_tpu_torch.erasure.codec import cached_erasure
    from minio_tpu_torch.ops import highwayhash_torch as hh

    erasure = cached_erasure(K, M, BLOCK, "dense-gf8", "cuda")
    lengths = sorted({erasure.chunk_size(size % BLOCK) for size in
                      sizes.values() if size % BLOCK} - {0})
    for codec in SELF_HEAL_CODECS[:2]:
        mat = registry.get(codec).parity_matrix(K, M)
        err = gf_matrix_err(rng, errs, mat, [(1, K, ln) for ln in lengths])
        log(f"gf_apply {codec} encode at the .minio.sys objects' shard "
            f"lengths {lengths} ({sizes}): max_abs_err {err}")
    for ln in lengths:
        x = rand((K + M, ln), rng)
        got = hh.hash256_batch(x)
        want = hh._hash256_plain(x, hh.MAGIC_KEY)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs["highwayhash256"] = max(errs["highwayhash256"], err)
        log(f"highwayhash256 hash256_batch {tuple(x.shape)}: "
            f"max_abs_err {err}")
        for groups in (K, K + M):
            err = grouped_verify_case(rng, groups, 1, ln)
            errs["hh256_verify_grouped"] = max(errs["hh256_verify_grouped"],
                                               err)
    bad = {k: v for k, v in errs.items() if v != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"at the .minio.sys lengths: {bad}")


def grouped_verify_case(rng, groups: int, n: int, s: int) -> int:
    """Kernel B's grouped verify entry against its plain version on
    `groups` fetches of n frames of s bytes and one short last frame
    each; returns the max abs difference of the first-bad answers."""
    from minio_tpu_torch.ops import highwayhash_torch as hh

    tail = max(1, s // 3)
    group = n * (32 + s) + 32 + tail
    buf = rand((1 + groups * group,), rng)[1:]
    # Digests from kernel B's hash entry, held to the plain hash at these
    # lengths above.
    for g in range(groups):
        o = g * group
        hh._rows(buf, o, 32 + s, n, 32).copy_(
            hh.hash256_pitched(buf, o + 32, 32 + s, n, s))
        o += n * (32 + s)
        hh._rows(buf, o, 32, 1, 32).copy_(
            hh.hash256_pitched(buf, o + 32, 32, 1, tail))
    bad = dict.fromkeys((g % groups, i) for g, i in (
        (1, 0), (5, n - 1), (11, 0), (11, n - 1), (7, n), (groups - 1, 0),
        (groups - 1, n), (groups - 2, n - 1)))
    for g, i in bad:
        # A byte of the chunk (its ninth, or its last when shorter).
        length = s if i < n else tail
        buf[g * group + i * (32 + s) + 32 + min(8, length - 1)] ^= 0x41
    # Where the flips are: a group's first bad full-size frame (n if
    # none), and 0 or 1 for its short last frame.
    expect = [torch.tensor([min([i for gg, i in bad if gg == g and i < n],
                                default=n) for g in range(groups)]),
              torch.tensor([0 if (g, n) in bad else 1
                            for g in range(groups)])]
    got = [hh.verify_frames_grouped(buf, groups, group, n, s),
           hh.verify_frames_grouped(buf, groups, group, 1, tail,
                                    offset=n * (32 + s))]
    torch.cuda.synchronize()
    host = buf.cpu()
    plain = [hh.verify_frames_grouped(host, groups, group, n, s),
             hh.verify_frames_grouped(host, groups, group, 1, tail,
                                      offset=n * (32 + s))]
    err = max(max(max_abs_err(a.cpu(), b), max_abs_err(b, e))
              for a, b, e in zip(got, plain, expect))
    log(f"hh256_verify_grouped {groups} groups x {n} frames of {s} B and "
        f"one of {tail} B: kernel {got[0].tolist()} / {got[1].tolist()}, "
        f"plain {plain[0].tolist()} / {plain[1].tolist()}, "
        f"max_abs_err {err}")
    return err


def check_kernels(rng) -> dict:
    """Phase 3: every kernel against its plain version, exact."""
    from minio_tpu_torch.entry import entry
    from minio_tpu_torch.ops import gf, highwayhash_torch as hh, rs, rs_cuda

    errs = {"gf_apply": 0, "highwayhash256": 0, "hh256_verify": 0,
            "hh256_verify_grouped": 0}
    fn, (bitmat, blocks) = entry("cuda")  # 12+4 encode, [8, 12, 87382]
    cases = [("encode 12+4", bitmat, blocks)]
    # The encode and every reconstruction of the main paths.
    recs = [("encode 12+4", bitmat)]
    for unavailable, targets in path_reconstructions():
        present = [i for i in range(K + M) if i not in unavailable]
        recs.append((f"reconstruct 12+4 {targets} from {present[:K]}",
                     gf.to_device_bitmat(gf.bit_matrix(gf.reconstruct_matrix(
                         K, M, present, list(targets))), "cuda")))
    # One line a matrix: every path shard length at B = 1 and 8.
    shapes = [(b, K, s) for s in path_shard_lengths() for b in (1, BATCH)]
    for name, bm in recs:
        err = 0
        for shape in shapes:
            x = rand(shape, rng)
            got = rs_cuda.apply_gf_matrix_cuda(bm, x)
            want = rs._apply_bits_plain(bm, x)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, want))
        log(f"gf_apply {name} at [B, {K}, S] for B in (1, {BATCH}), S in "
            f"{path_shard_lengths()}: max_abs_err {err}")
        errs["gf_apply"] = max(errs["gf_apply"], err)
    # Wide geometries minio_tpu accepts, and S = 1, 2, 3 mod 16.
    for k, m, s in ((16, 16, 333), (2, 2, 333), (40, 40, 1000),
                    (128, 128, 257), (200, 56, 515), (K, M, 4097),
                    (K, M, 4098), (K, M, 4099)):
        bm = gf.to_device_bitmat(gf.bit_matrix(gf.parity_matrix(k, m)),
                                 "cuda")
        cases.append((f"encode {k}+{m} S={s}", bm, rand((2, k, s), rng)))
    lost40 = list(range(0, 80, 2))
    rec40 = gf.reconstruct_matrix(
        40, 40, [i for i in range(80) if i not in lost40], lost40)
    cases.append(("reconstruct 40+40 lost 40",
                  gf.to_device_bitmat(gf.bit_matrix(rec40), "cuda"),
                  rand((2, 40, 1000), rng)))
    for name, bm, x in cases:
        got = rs_cuda.apply_gf_matrix_cuda(bm, x)
        want = rs._apply_bits_plain(bm, x)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        log(f"gf_apply {name} {tuple(x.shape)}: max_abs_err {err}")
        errs["gf_apply"] = max(errs["gf_apply"], err)
    got_entry = fn(bitmat, blocks)
    if not torch.equal(got_entry, rs._apply_bits_plain(bitmat, blocks)):
        raise AssertionError("entry() output differs from the plain version")

    def hash_case(name, buf, offset, pitch, n, length):
        got = hh.hash256_pitched(buf, offset, pitch, n, length)
        want = hh._hash256_plain(hh._rows(buf, offset, pitch, n, length),
                                 hh.MAGIC_KEY)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        log(f"highwayhash256 {name}: max_abs_err {err}")
        errs["highwayhash256"] = max(errs["highwayhash256"], err)
        return want

    # The PUT's and heal's digests: contiguous rows, as hash256_batch
    # takes them.
    for s in path_shard_lengths():
        x = rand((BATCH * (K + M), s), rng)
        got = hh.hash256_batch(x)
        want = hh._hash256_plain(x, hh.MAGIC_KEY)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        log(f"highwayhash256 hash256_batch {tuple(x.shape)}: "
            f"max_abs_err {err}")
        errs["highwayhash256"] = max(errs["highwayhash256"], err)
    # Chunk starts at every offset mod 16 (20 rows: two blocks of 16).
    for off in range(16):
        n, ln = 20, 4096 + 22
        hash_case(f"[{n}, {ln}] from offset {off}",
                  rand((off + n * ln,), rng), off, ln, n, ln)
    # Framed buffers [digest || chunk]* at pitch 32 + L from an odd
    # address, then the verify entry on good and corrupted frames: a
    # reader's fetch of full chunks, and a short last chunk alone. The
    # plain verify is run where it takes under a second (L < 87,382).
    framed_cases = [(20, ln) for ln in HASH_LENGTHS]
    for s in path_shard_lengths():
        framed_cases += [(2 * (K + M), s), (1, s)]
    for n, ln in framed_cases:
        pitch = 32 + ln
        framed = rand((3 + n * pitch,), rng)[3:]
        want = hash_case(f"framed [{n}, {ln}] pitch {pitch}", framed, 32,
                         pitch, n, ln)
        hh._rows(framed, 0, pitch, n, 32).copy_(want)
        for bad in dict.fromkeys(b for b in ((), (0,), (5, n - 1), (n - 1,))
                                 if all(i < n for i in b)):
            f = framed.clone()
            for i in bad:
                f[i * pitch + (32 + ln // 2 if ln else 5)] ^= 0x41
            expect = bad[0] if bad else -1
            got = hh.verify_frames(f, n, ln)
            plain = hh.verify_frames(f.cpu(), n, ln) if ln < SHARD else expect
            err = abs(got - expect) + abs(plain - expect)
            log(f"hh256_verify framed [{n}, {ln}] bad {bad}: kernel {got}, "
                f"plain {plain if ln < SHARD else 'not run'}, "
                f"max_abs_err {err}")
            errs["hh256_verify"] = max(errs["hh256_verify"], err)
    # The grouped verify as the reader calls it: a fetch of BATCH frames
    # from each of K readers (a healthy fetch) or of K + M (the lo..hi
    # span a degraded fetch can verify) at a group pitch, bad chunks first
    # and last in several groups and in a short last chunk, the full-size
    # chunks in one launch and the short last chunk in a second.
    for s in path_shard_lengths():
        for groups in (K, K + M):
            err = grouped_verify_case(rng, groups, BATCH, s)
            errs["hh256_verify_grouped"] = max(errs["hh256_verify_grouped"],
                                               err)
    check_codec_kernels(rng, errs)
    check_self_heal_kernels(rng, errs)
    bad = {k: v for k, v in errs.items() if v != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    return errs


def settle_heap() -> None:
    """Collect the garbage that the kernel checks, the traces and the last
    run leave, outside the timings. Nothing is frozen: the main paths run
    under the collector's full passes as a server's requests do."""
    gc.collect()


# Collector passes over 20 ms during the main paths, (generation, s): a
# pass holds every thread; one over the hedge delay (0.15 s) during a
# reader's wait restarts its hedge window (once a fetch), and a second in
# the same fetch would show as a hedged read.
PAUSES: list = []
# Hedge windows restarted after an oversleeping wait, by check label.
RESTARTS: dict = {}
_gc_t0 = [0.0]


def on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _gc_t0[0] = time.perf_counter()
    elif time.perf_counter() - _gc_t0[0] > 0.02:
        PAUSES.append((info["generation"],
                       round(time.perf_counter() - _gc_t0[0], 4)))


def reset_counts() -> None:
    """Zero every launch counter, just before a main path runs."""
    from minio_tpu_torch.erasure import device_engine
    from minio_tpu_torch.ops import highwayhash_torch, rs_cuda

    rs_cuda.LAUNCHES.reset()
    rs_cuda.LAUNCHES_BY_SHAPE.reset()
    highwayhash_torch.LAUNCHES.reset()
    device_engine.reset_stats()


def read_counts() -> dict:
    from minio_tpu_torch.ops import highwayhash_torch, rs_cuda

    return {"gf_apply": rs_cuda.LAUNCHES.value,
            "highwayhash256": highwayhash_torch.LAUNCHES.value}


def read_shape_counts() -> dict:
    """Kernel A's launches by shape, "{R}x{K}", counted by its wrapper."""
    from minio_tpu_torch.ops import rs_cuda

    return rs_cuda.LAUNCHES_BY_SHAPE.snapshot()


def run_main_path() -> dict:
    """Phase 4: put_get_heal through the port's entry point."""
    from minio_tpu_torch.entry import put_get_heal

    data_root = ROOT / ".smoke_data"
    data_root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=data_root)
    try:
        reset_counts()
        res = put_get_heal(tmp, OBJECT_SIZE, K, M, LOST, seed=0,
                           device="cuda", block_size=BLOCK)
        launches = read_counts()
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    payload = np.random.default_rng(0).bytes(OBJECT_SIZE)
    for key in ("get_ok", "range_ok", "healed_identical", "reverified"):
        if res[key] is not True:
            raise AssertionError(f"main path check {key} failed")
    if res["bytes"] != payload or len(res["bytes"]) != OBJECT_SIZE:
        raise AssertionError("GET bytes differ from the payload")
    for ph in ("put", "get", "heal"):
        c = res["counters"][ph]
        for key in ("launches_gf", "launches_hash", "kernel_gf_launches",
                    "kernel_hash_launches"):
            if c[key] <= 0:
                raise AssertionError(f"{ph}: {key} did not rise ({c})")
    check_fanout("main path", res["counters"], PIPELINED_PHASES)
    for ph, sec in res["seconds"].items():
        gbps = OBJECT_SIZE / sec / 1e9 if ph != "range_get" else float("nan")
        log(f"phase {ph}: {sec:.4f} s, {gbps:.4f} GB/s of object, "
            f"counters {res['counters'][ph]}")
    log(f"heal hint from the degraded GET: {res['heal_hint']}")
    return launches


# Phase 4's phases whose copies to the card must all be pinned on the
# pipelined drivers, and those that read through the ParallelReader.
PIPELINED_PHASES = ("put", "get_healthy", "get", "range_get")
READ_PHASES = ("get_healthy", "get", "range_get", "heal")


def check_fanout(label: str, counters: dict, pinned_phases=(),
                 read_phases=READ_PHASES) -> None:
    """No read hedged in any phase (no drive stalls in these runs); one
    grouped verify launch a reader fetch with full-size chunks in each
    read phase; no pageable copy to the card in `pinned_phases`. Tallies
    the hedge windows restarted into RESTARTS."""
    RESTARTS[label] = RESTARTS.get(label, 0) + sum(
        c["hedge_windows_restarted"] for c in counters.values())
    for ph, c in counters.items():
        if c["hedged_reads_total"]:
            raise AssertionError(f"{label} {ph}: {c['hedged_reads_total']} "
                                 "hedged reads on a healthy run")
        if ph in read_phases and c["launches_verify"] != \
                c["reader_fetches_full"]:
            raise AssertionError(
                f"{label} {ph}: {c['launches_verify']} grouped verify "
                f"launches for {c['reader_fetches_full']} fetches")
        if ph in pinned_phases and (c["h2d_pageable"]
                                    or not c["h2d_pinned"]):
            raise AssertionError(
                f"{label} {ph}: {c['h2d_pageable']} pageable and "
                f"{c['h2d_pinned']} pinned copies to the card")


def run_object_layer() -> tuple[dict, dict]:
    """Phase 4c: object_put_get_heal through the port's object layer."""
    from minio_tpu_torch.entry import object_put_get_heal

    data_root = ROOT / ".smoke_data"
    data_root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=data_root)
    try:
        reset_counts()
        res = object_put_get_heal(tmp, OBJECT_SIZE, device="cuda",
                                  inline_size=INLINE_SIZE, seed=2)
        launches = read_counts()
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    failed = [k for k, ok in res["checks"].items() if ok is not True]
    if failed:
        raise AssertionError(f"object layer checks failed: {failed}")
    check_fanout("object layer", res["counters"], ("put", "get"),
                 read_phases=("get", "degraded_get", "range_get", "heal"))
    per_phase = {}
    for ph, c in res["counters"].items():
        gf_n, hh_n = c["kernel_gf_launches"], c["kernel_hash_launches"]
        per_phase[ph] = {"gf_apply": gf_n, "highwayhash256": hh_n,
                         "hedged_reads": c["hedged_reads_total"]}
        want_gf = ph not in ("get", "get_inline", "verify", "bitrot_verify")
        if hh_n <= 0 or (gf_n > 0) != want_gf:
            raise AssertionError(
                f"object layer {ph}: kernel A launched {gf_n} times, "
                f"kernel B {hh_n} (want A {'> 0' if want_gf else '0'}, "
                f"B > 0)")
        log(f"object layer {ph}: {res['seconds'][ph]:.4f} s, launches "
            f"A {gf_n} B {hh_n}, counters {c}")
    line = {"object_size": res["size"], "inline_size": res["inline_size"],
            "k": K, "m": M, "lost": res["lost"],
            "seconds": res["seconds"], "launches": per_phase,
            "heal_result": res["heal_result"], "checks": res["checks"]}
    return line, launches


# Phase 4e's serial phases, and whether each launches kernel A (kernel B
# launches in all but the listings and MakeBucket).
S3_PHASES = {"make_bucket": None, "put": True, "multipart": True,
             "put_small": True, "list": None, "list_delimiter": None,
             "get": False, "range_get": False, "degraded_get": True,
             "degraded_get_multipart": True, "heal": True}


def run_s3_plane() -> tuple[dict, dict]:
    """Phase 4e: s3_put_get_heal, the S3 plane over HTTP on localhost."""
    from minio_tpu_torch.entry import s3_put_get_heal

    data_root = ROOT / ".smoke_data"
    data_root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=data_root)
    try:
        reset_counts()
        res = s3_put_get_heal(tmp, OBJECT_SIZE, device="cuda",
                              part_size=MP_PART, parts=MP_PARTS,
                              last_part=MP_LAST, small_count=SMALL_COUNT,
                              small_sizes=SMALL_SIZES, page=100,
                              concurrent=4, seed=4)
        launches = read_counts()
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    failed = [k for k, ok in res["checks"].items() if ok is not True]
    if failed:
        raise AssertionError(f"S3 plane checks failed: {failed}")
    check_fanout("s3 plane", res["counters"], read_phases=(
        "get", "range_get", "degraded_get", "degraded_get_multipart"))
    per_phase = {}
    for ph, want_gf in S3_PHASES.items():
        c = res["counters"][ph]
        gf_n, hh_n = c["kernel_gf_launches"], c["kernel_hash_launches"]
        per_phase[ph] = {"gf_apply": gf_n, "highwayhash256": hh_n,
                         "hedged_reads": c["hedged_reads_total"]}
        if want_gf is None:
            ok, want = gf_n == hh_n == 0, "none"
        else:
            ok = hh_n > 0 and (gf_n > 0) == want_gf
            want = f"A {'> 0' if want_gf else '0'}, B > 0"
        if not ok:
            raise AssertionError(f"S3 plane {ph}: kernel A launched {gf_n} "
                                 f"times, kernel B {hh_n} (want {want})")
        log(f"s3 plane {ph}: {res['seconds'][ph]:.4f} s, launches A {gf_n} "
            f"B {hh_n}")
    log(f"s3 plane concurrent GETs (4, bytes checked): "
        f"{res['concurrent_get_seconds']:.4f} s, hedged reads "
        f"{res['counters']['concurrent_get']['hedged_reads_total']}")
    line = {"object_size": res["size"],
            "multipart_size": res["multipart_size"], "parts": res["parts"],
            "small_objects": res["small_count"], "k": K, "m": M,
            "wiped_drives": res["wiped_drives"],
            "seconds": res["seconds"], "launches": per_phase,
            "concurrent_get_seconds": res["concurrent_get_seconds"],
            "concurrent_get_hedged_reads":
                res["counters"]["concurrent_get"]["hedged_reads_total"],
            "list_pages": res["list_pages"], "heal": res["heal"],
            "healed_files": res["healed_files"], "checks": res["checks"]}
    return line, launches


# Phase 4h's phases, and whether each launches kernel A (kernel B
# launches in all of them: each writes or verifies).
CODEC_PHASES = {"put": True, "get": False, "degraded_get": True,
                "range_get": True, "heal": True, "repair_heal": True}


def run_codecs() -> tuple[dict, dict]:
    """Phase 4h: object_codec_put_get_heal in each codec cell, then one
    signed PUT with x-mtpu-codec: msr-pm over HTTP (s3_codec_put_get).
    Returns the {"codecs": ...} line and the launches of all of it."""
    from minio_tpu_torch.entry import (
        object_codec_put_get_heal,
        s3_codec_put_get,
    )

    data_root = ROOT / ".smoke_data"
    line: dict = {"object_size": OBJECT_SIZE, "cells": {}}
    launches = {"gf_apply": 0, "highwayhash256": 0}
    for i, (codec, drives, lost, target) in enumerate(CODEC_CELLS):
        k = drives - CODEC_PARITY
        label = f"{codec} {k}+{CODEC_PARITY}"
        data_root.mkdir(exist_ok=True)
        tmp = tempfile.mkdtemp(dir=data_root)
        try:
            reset_counts()
            res = object_codec_put_get_heal(
                tmp, OBJECT_SIZE, codec, drives=drives, parity=CODEC_PARITY,
                lost=lost, repair_target=target, device="cuda", seed=10 + i)
            got = read_counts()
        finally:
            shutil.rmtree(data_root, ignore_errors=True)
        failed = [key for key, ok in res["checks"].items() if ok is not True]
        if failed:
            raise AssertionError(f"4h {label} checks failed: {failed} "
                                 f"({res.get('repair')})")
        check_fanout(f"4h {label}", res["counters"], ("put", "get"),
                     read_phases=("get", "degraded_get", "range_get",
                                  "heal"))
        per_phase = {}
        for ph, c in res["counters"].items():
            gf_n, hh_n = c["kernel_gf_launches"], c["kernel_hash_launches"]
            per_phase[ph] = {"gf_apply": gf_n, "highwayhash256": hh_n}
            if hh_n <= 0 or (gf_n > 0) != CODEC_PHASES[ph]:
                raise AssertionError(
                    f"4h {label} {ph}: kernel A launched {gf_n} times, "
                    f"kernel B {hh_n} (want A "
                    f"{'> 0' if CODEC_PHASES[ph] else '0'}, B > 0)")
            log(f"4h {label} {ph}: {res['seconds'][ph]:.4f} s, launches "
                f"A {gf_n} B {hh_n}")
        if target is not None:
            c = res["counters"]["repair_heal"]
            log(f"4h {label} repair of shard {target}: {res['repair']}, "
                f"parts repaired {c['repair_parts_repaired']}, fallbacks "
                f"{c['repair_fallbacks']}")
        for name in launches:
            launches[name] += got[name]
        line["cells"][label] = {
            "codec": codec, "k": k, "m": CODEC_PARITY, "lost": list(lost),
            "repair_target": target, "seconds": res["seconds"],
            "launches": per_phase, "repair": res.get("repair"),
            "checks": res["checks"]}
    data_root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=data_root)
    try:
        reset_counts()
        res = s3_codec_put_get(tmp, S3_CODEC_SIZE, "msr-pm", device="cuda",
                               seed=20)
        got = read_counts()
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    failed = [key for key, ok in res["checks"].items() if ok is not True]
    if failed:
        raise AssertionError(f"4h S3 x-mtpu-codec PUT checks failed: "
                             f"{failed} (xl.meta {res['xl_meta_codecs']})")
    per_phase = {}
    for ph, want_gf in (("put", True), ("get", False)):
        c = res["counters"][ph]
        gf_n, hh_n = c["kernel_gf_launches"], c["kernel_hash_launches"]
        per_phase[ph] = {"gf_apply": gf_n, "highwayhash256": hh_n}
        if hh_n <= 0 or (gf_n > 0) != want_gf:
            raise AssertionError(f"4h S3 {ph}: kernel A launched {gf_n} "
                                 f"times, kernel B {hh_n}")
    for name in launches:
        launches[name] += got[name]
    log(f"4h S3 x-mtpu-codec: msr-pm PUT of {S3_CODEC_SIZE} B: "
        f"{res['seconds']}, xl.meta names {res['xl_meta_codecs']}, "
        f"launches {per_phase}")
    line["s3_header_put"] = {"size": S3_CODEC_SIZE, "codec": "msr-pm",
                             "seconds": res["seconds"],
                             "launches": per_phase,
                             "xl_meta_codecs": res["xl_meta_codecs"],
                             "checks": res["checks"]}
    return line, launches


def trace_path(label: str, run, size: int = TRACE_SIZE):
    """Phases 4b and 4d: one traced run (torch.profiler, CPU + CUDA) of a
    main path at a quarter of the main size: device busy time by kernel
    name and the device's busy share of the traced wall time. Tracing
    slows the host, so these are shares, not the phase times above.
    run(tmp_dir, size) drives the path and returns whether its checks
    held. Returns {"wall_s", "device_busy_s"}, or None when the trace
    recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    data_root = ROOT / ".smoke_data"
    data_root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=data_root)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ok = run(tmp, size)
            wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    if not ok:
        raise AssertionError(f"traced {label} returned wrong bytes")
    # Device-side events only (kernels, copies): host ops that launched
    # them report the same device time again.
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    if not rows:
        log(f"trace {label}: no device time recorded; device busy share "
            "not measured")
        return None
    log(f"trace {label}: {size} B object, traced wall {wall:.3f} s, device "
        f"busy {busy_ms / 1e3:.3f} s ({100 * busy_ms / 1e3 / wall:.1f}% "
        "of wall)")
    for key, count, ms in rows[:10]:
        log(f"trace:   {ms:10.3f} ms  {count:6d}x  {key[:90]}")
    # Copies by kind, as the trace names them ("Memcpy HtoD (Pinned ->
    # Device)", "... (Pageable -> Device)", ...).
    copies = {key: {"count": count, "ms": ms} for key, count, ms in rows
              if key.startswith("Memcpy")}
    del prof
    settle_heap()
    return {"wall_s": wall, "device_busy_s": busy_ms / 1e3,
            "idle_share": 1 - busy_ms / 1e3 / wall, "copies": copies}


def traced_put_get_heal(tmp, size) -> bool:
    from minio_tpu_torch.entry import put_get_heal

    res = put_get_heal(tmp, size, K, M, LOST, seed=1, device="cuda",
                       block_size=BLOCK)
    return res["get_ok"] and res["healed_identical"]


def traced_object_layer(tmp, size) -> bool:
    from minio_tpu_torch.entry import object_put_get_heal

    res = object_put_get_heal(tmp, size, device="cuda",
                              inline_size=INLINE_SIZE, seed=3)
    return all(res["checks"].values())


def traced_s3_plane(tmp, size) -> bool:
    from minio_tpu_torch.entry import s3_put_get_heal

    res = s3_put_get_heal(tmp, size, device="cuda", part_size=MP_PART,
                          parts=2, last_part=MP_LAST, small_count=16,
                          small_sizes=SMALL_SIZES, concurrent=0, seed=5)
    return all(res["checks"].values())


DRIVER_PHASES = ("put", "get_healthy", "get", "heal")


def run_drivers() -> dict:
    """Phase 4g: phase 4's path through the serial drivers and the
    pipelined drivers in turns, three times each, then one traced run of
    each. Returns the {"pipelined": ...} line."""
    from minio_tpu_torch.entry import put_get_heal
    from minio_tpu_torch.utils import fanout

    from minio_tpu_torch.pipeline import stage_stats_snapshot

    host_single_core = fanout.SINGLE_CORE
    drivers = ("serial", "pipelined")
    stages_before = stage_stats_snapshot()
    seconds: dict = {d: {ph: [] for ph in DRIVER_PHASES} for d in drivers}
    counters: dict = {}
    shards: dict = {}
    data_root = ROOT / ".smoke_data"
    try:
        for _ in range(3):
            for driver in drivers:
                fanout.SINGLE_CORE = driver == "serial"
                data_root.mkdir(exist_ok=True)
                tmp = tempfile.mkdtemp(dir=data_root)
                res = None
                settle_heap()  # the last run's garbage, outside the timings
                try:
                    res = put_get_heal(tmp, OBJECT_SIZE, K, M, LOST, seed=0,
                                       device="cuda", block_size=BLOCK)
                finally:
                    shutil.rmtree(data_root, ignore_errors=True)
                for key in ("healthy_get_ok", "get_ok", "range_ok",
                            "healed_identical", "reverified"):
                    if res[key] is not True:
                        raise AssertionError(f"4g {driver}: {key} failed")
                if shards.setdefault(driver, res["shard_sha256"]) != \
                        res["shard_sha256"]:
                    raise AssertionError(f"4g {driver}: shard files differ "
                                         "between runs")
                check_fanout(f"4g {driver}", res["counters"],
                             PIPELINED_PHASES if driver == "pipelined"
                             else ())
                for ph in DRIVER_PHASES:
                    seconds[driver][ph].append(res["seconds"][ph])
                counters[driver] = res["counters"]
        if shards["serial"] != shards["pipelined"]:
            raise AssertionError("4g: serial and pipelined shard files differ")
        # Each pipeline stage's seconds busy, starved and stalled, a run.
        stages = {}
        for key, v in stage_stats_snapshot().items():
            b = stages_before.get(key, {})
            if v["items"] > b.get("items", 0):  # the stages 4g ran
                stages[key] = {
                    f: round((v[f] - b.get(f, 0)) / 3, 4)
                    for f in ("items", "busy_s", "wait_s", "stall_s")}
        for key, v in stages.items():
            log(f"4g pipelined stage {key}: {v} a run")
        traces = {}
        for driver in drivers:
            fanout.SINGLE_CORE = driver == "serial"
            traces[driver] = trace_path(f"4g {driver} drivers",
                                        traced_put_get_heal)
    finally:
        fanout.SINGLE_CORE = host_single_core
    line: dict = {"object_size": OBJECT_SIZE, "k": K, "m": M,
                  "lost": list(LOST), "runs": 3,
                  "shards_identical": True, "seconds": {}, "per_fetch": {},
                  "h2d": {}, "hedged_reads_total": {}, "trace": traces,
                  "stages": stages}
    for driver in drivers:
        line["seconds"][driver] = {
            ph: {"min": min(v), "spread": max(v) - min(v), "runs": v}
            for ph, v in seconds[driver].items()}
        c = counters[driver]
        line["per_fetch"][driver] = {
            ph: {"fetches": c[ph]["reader_fetches"],
                 "full_fetches": c[ph]["reader_fetches_full"],
                 "verify_launches": c[ph]["launches_verify"],
                 "verify_tail_launches": c[ph]["launches_verify_tail"]}
            for ph in READ_PHASES}
        line["h2d"][driver] = {
            ph: {"pinned": c[ph]["h2d_pinned"],
                 "pageable": c[ph]["h2d_pageable"],
                 "pinned_bytes": c[ph]["h2d_pinned_bytes"],
                 "pageable_bytes": c[ph]["h2d_pageable_bytes"]}
            for ph in DRIVER_PHASES}
        line["hedged_reads_total"][driver] = sum(
            c[ph]["hedged_reads_total"] for ph in c)
        for ph in DRIVER_PHASES:
            v = seconds[driver][ph]
            log(f"4g {driver} {ph}: min {min(v):.4f} s, spread "
                f"{max(v) - min(v):.4f} s, runs "
                f"{', '.join(f'{x:.4f}' for x in v)}")
    return line


# Phase 4i's steps, and whether each launches kernel A (True, False) or
# neither kernel (None); kernel B launches in every step that launches
# anything. "versioning" and "policy" write the bucket's metadata.json.
CORE_STEPS = {"versioning": True, "put_v1": True, "put_v2": True,
              "list_versions": None, "delete_marker": None,
              "get_marked": None, "get_v1": False, "get_v2": False,
              "degraded_get_v1": True, "copy": True, "get_copy": False,
              "part_copy": True, "get_parts": False, "self_copy": None,
              "tagging": None, "put_small": True, "delete_objects": None,
              "list_after_delete": None, "list_versions_small": None,
              "policy": True, "heal_bucket": True, "heal_versions": True}


def run_s3_core() -> tuple[dict, dict]:
    """Phase 4i: s3_core, the S3 object core over HTTP on localhost."""
    from minio_tpu_torch.entry import s3_core

    data_root = ROOT / ".smoke_data"
    data_root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=data_root)
    try:
        reset_counts()
        res = s3_core(tmp, OBJECT_SIZE, device="cuda",
                      small_count=CORE_SMALL_COUNT,
                      small_size=CORE_SMALL_SIZE, page=100, seed=30)
        launches = read_counts()
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    failed = [k for k, ok in res["checks"].items() if ok is not True]
    if failed:
        raise AssertionError(f"S3 object core checks failed: {failed}")
    check_fanout("s3 core", res["counters"], read_phases=(
        "get_v1", "get_v2", "degraded_get_v1", "get_copy", "get_parts"))
    per_phase = {}
    for ph, want_gf in CORE_STEPS.items():
        c = res["counters"][ph]
        gf_n, hh_n = c["kernel_gf_launches"], c["kernel_hash_launches"]
        per_phase[ph] = {"gf_apply": gf_n, "highwayhash256": hh_n,
                         "hedged_reads": c["hedged_reads_total"]}
        if want_gf is None:
            ok, want = gf_n == hh_n == 0, "none"
        else:
            ok = hh_n > 0 and (gf_n > 0) == want_gf
            want = f"A {'> 0' if want_gf else '0'}, B > 0"
        if ph in ("copy", "part_copy"):
            # Every pull from the degraded source rebuilds its block.
            ok = ok and gf_n >= c["copy_pulls"] > 0
            want += ", A >= pulls"
        if not ok:
            raise AssertionError(f"S3 core {ph}: kernel A launched {gf_n} "
                                 f"times, kernel B {hh_n}, pulls "
                                 f"{c['copy_pulls']} (want {want})")
        log(f"s3 core {ph}: {res['seconds'][ph]:.4f} s, launches A {gf_n} "
            f"B {hh_n}, pulls {c['copy_pulls']}")
    log(f"s3 core copies: {res['copy_bytes']}, heal {res['heal']}")
    line = {"object_size": res["size"], "k": K, "m": M,
            "wiped_drives": res["wiped_drives"],
            "small_objects": res["small_count"],
            "part_copy_ranges": res["part_copy_ranges"],
            "seconds": res["seconds"], "launches": per_phase,
            "copy_bytes": res["copy_bytes"],
            "version_pages": res["version_pages"], "heal": res["heal"],
            "healed_files": res["healed_files"], "checks": res["checks"]}
    return line, launches


# Phase 4j's steps, and whether each launches kernel A (kernel B launches
# in every one: each writes, verifies or rebuilds).
SELF_HEAL_STEPS = {"load": True, "outage_put": True, "mrf_drain": True,
                   "outage_degraded_get": True, "sweep": True,
                   "scan_cycle": True, "scan_cycle_2": True}


def run_self_heal() -> tuple[dict, dict, dict]:
    """Phase 4j: entry.self_heal, the self-healing services of a running
    Server. Kernel A's launches are also read by shape, (rows out) x
    (rows in), from its wrapper's count. Returns the {"self_heal": ...}
    line, the launches, and the sizes of the objects the server wrote
    under .minio.sys."""
    from minio_tpu_torch.entry import self_heal

    data_root = ROOT / ".smoke_data"
    data_root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=data_root)
    try:
        reset_counts()
        res = self_heal(tmp, OBJECT_SIZE, device="cuda",
                        small_count=SMALL_COUNT, small_sizes=SMALL_SIZES,
                        seed=40)
        launches = read_counts()
        tally = read_shape_counts()
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    if sum(tally.values()) != launches["gf_apply"]:
        raise AssertionError(f"kernel A's launches by shape {tally} do not "
                             f"add up to its {launches['gf_apply']}")
    failed = [k for k, ok in res["checks"].items() if ok is not True]
    if failed:
        raise AssertionError(f"self-heal checks failed: {failed} "
                             f"(sweep {res.get('sweep')})")
    per_phase = {}
    for ph, want_gf in SELF_HEAL_STEPS.items():
        c = res["counters"][ph]
        gf_n, hh_n = c["kernel_gf_launches"], c["kernel_hash_launches"]
        per_phase[ph] = {"gf_apply": gf_n, "highwayhash256": hh_n,
                         "hedged_reads": c["hedged_reads_total"]}
        if hh_n <= 0 or (gf_n > 0) != want_gf:
            raise AssertionError(f"self heal {ph}: kernel A launched {gf_n} "
                                 f"times, kernel B {hh_n}")
        log(f"4j {ph}: {res['seconds'][ph]:.4f} s, launches A {gf_n} "
            f"B {hh_n}")
    for key in ("outage_pulled", "reconnect", "return_to_empty_mrf",
                "wipe_to_healed", "detect"):
        log(f"4j {key}: {res['seconds'][key]:.4f} s")
    log(f"4j codecs the server stamped: {res['codecs']}")
    log(f"4j sweep: {res['sweep']}")
    log(f"4j kernel A launches by (rows out)x(rows in): {tally}")
    line = {"object_size": res["size"], "k": K, "m": M,
            "outage_drive": res["outage_drive"],
            "wiped_drive": res["wiped_drive"],
            "offline_drives": res["offline_drives"],
            "objects": res["objects"], "codecs": res["codecs"],
            "mrf_queued": res["mrf_queued"], "seconds": res["seconds"],
            "launches": per_phase, "gf_apply_by_shape": tally,
            "sweep": res["sweep"], "usage": res["usage"],
            "checks": res["checks"]}
    return line, launches, res["system_objects"]


def traced_self_heal(tmp, size) -> bool:
    from minio_tpu_torch.entry import object_self_heal

    res = object_self_heal(tmp, size, device="cuda", seed=41)
    return all(res["checks"].values())


def time_kernels(rng, launches: dict, errs: dict) -> list[dict]:
    """Phase 5: kernel, plain and bound times at the main shapes.
    `launches` holds each kernel's launches by main path."""
    from minio_tpu_torch.ops import gf, highwayhash_torch as hh, rs, rs_cuda
    from minio_tpu_torch.utils.timing import time_calls, time_graph

    bitmat = gf.to_device_bitmat(gf.bit_matrix(gf.parity_matrix(K, M)),
                                 "cuda")
    enc_in = [rand((BATCH, K, SHARD), rng) for _ in range(8)]  # 8 x 11 MB
    def gf_fn(x):
        return rs_cuda.apply_gf_matrix_cuda(bitmat, x)

    gf_ms = time_graph(gf_fn, enc_in, 200)
    gf_call_ms = time_calls(gf_fn, enc_in, 200)
    gf_plain_ms = time_calls(lambda x: rs._apply_bits_plain(bitmat, x),
                            enc_in, 10)
    gf_bytes = BATCH * (K + M) * SHARD + bitmat.numel()
    gf_ops = 2 * (8 * M) * (8 * K) * BATCH * SHARD  # the GF(2) product
    gf_bound = 1e3 * max(gf_bytes / HBM_BYTES_PER_S, gf_ops / INT8_OPS_PER_S)
    log(f"gf_apply [{BATCH}, {K}, {SHARD}] cold: {gf_ms:.5f} ms a launch "
        f"({gf_call_ms:.5f} ms a call from Python), bound {gf_bound:.5f} ms "
        f"({100 * gf_bound / gf_ms:.1f}% of bound)")

    # Kernel A at phase 4h's msr-pm encode shapes, in the sub-shard view.
    from minio_tpu_torch.erasure import registry
    from minio_tpu_torch.erasure.codec import cached_erasure

    codec_shapes = []
    for k, m in ((K, M), (4, 4)):
        entry = registry.get("msr-pm")
        a = entry.alpha(k, m)
        sub = cached_erasure(k, m, BLOCK, "msr-pm", "cuda").shard_size() // a
        bm = gf.to_device_bitmat(gf.bit_matrix(entry.parity_matrix(k, m)),
                                 "cuda")
        xs = [rand((BATCH, k * a, sub), rng) for _ in range(8)]
        ms = time_graph(lambda x, bm=bm: rs_cuda.apply_gf_matrix_cuda(bm, x),
                        xs, 200)
        plain_ms = time_calls(lambda x, bm=bm: rs._apply_bits_plain(bm, x),
                              xs, 10)
        rows_in, rows_out = k * a, m * a
        nbytes = BATCH * (rows_in + rows_out) * sub + bm.numel()
        ops = 2 * (8 * rows_out) * (8 * rows_in) * BATCH * sub
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S)
        codec_shapes.append({
            "codec": "msr-pm", "geometry": f"{k}+{m}", "alpha": a,
            "shape": [BATCH, rows_in, sub], "rows_out": rows_out, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= ops / INT8_OPS_PER_S else "operations"})
        log(f"gf_apply msr-pm {k}+{m} encode [{BATCH}, {rows_in}, {sub}] -> "
            f"{rows_out} cold: {ms:.5f} ms a launch, plain {plain_ms:.5f} "
            f"ms, bound {bound:.5f} ms ({100 * bound / ms:.1f}% of bound)")

    # Kernel A at phase 4j's heal shapes: the dense one-target
    # reconstruction [8, 12, 87,382] -> 1 and msr-pm 12+4's repair matrix
    # [alpha, T] on a window [nb, T, 43,691] of the repair plane.
    from minio_tpu_torch.erasure import repair

    heal_shapes = []
    one = gf.to_device_bitmat(gf.bit_matrix(gf.reconstruct_matrix(
        K, M, list(range(1, K + M)), [0])), "cuda")
    msr = registry.get("msr-pm")
    a = msr.alpha(K, M)
    sub = cached_erasure(K, M, BLOCK, "msr-pm", "cuda").shard_size() // a
    plan = msr.repair_plan(K, M, 3)
    nb = max(1, repair._WINDOW_BYTES // (plan.total_symbols * sub))
    rep_bm = gf.to_device_bitmat(gf.bit_matrix(plan.matrix), "cuda")
    for name, bm, shape in (
            ("one-target reconstruction 12+4", one, (BATCH, K, SHARD)),
            (f"msr-pm 12+4 repair of shard 3 [{plan.alpha}, "
             f"{plan.total_symbols}]", rep_bm,
             (nb, plan.total_symbols, sub))):
        xs = [rand(shape, rng) for _ in range(8)]
        ms = time_graph(lambda x, bm=bm: rs_cuda.apply_gf_matrix_cuda(bm, x),
                        xs, 200)
        plain_ms = time_calls(lambda x, bm=bm: rs._apply_bits_plain(bm, x),
                              xs, 10)
        rows_out, rows_in = bm.shape[0] // 8, shape[1]
        nbytes = shape[0] * (rows_in + rows_out) * shape[2] + bm.numel()
        ops = 2 * (8 * rows_out) * (8 * rows_in) * shape[0] * shape[2]
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S)
        heal_shapes.append({
            "name": name, "shape": list(shape), "rows_out": rows_out,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= ops / INT8_OPS_PER_S else "operations",
            "launches_4j": launches["gf_by_shape"].get(
                f"{rows_out}x{rows_in}", 0)})
        log(f"gf_apply {name} {list(shape)} -> {rows_out} cold: {ms:.5f} ms "
            f"a launch, plain {plain_ms:.5f} ms, bound {bound:.5f} ms "
            f"({100 * bound / ms:.1f}% of bound), launches in 4j "
            f"{heal_shapes[-1]['launches_4j']}")

    packets = SHARD // 32

    def hash_fn(x):
        return hh._hash256_cuda(x, hh.MAGIC_KEY)

    # Cold: the PUT shape, cycling through inputs beyond the 50 MB L2.
    hash_in = [rand((BATCH * (K + M), SHARD), rng) for _ in range(6)]
    hh_ms = time_graph(hash_fn, hash_in, 24)
    hh_plain_ms = time_calls(lambda x: hh._hash256_plain(x, hh.MAGIC_KEY),
                            hash_in[:1], 1)
    hh_bytes = BATCH * (K + M) * (SHARD + 32)
    hh_bound = 1e3 * hh_bytes / HBM_BYTES_PER_S
    # Warm: the GET shape, one reader fetch of BATCH chunks just written
    # (it stays in L2), hashed in place as frames; then the verify entry
    # as the reader calls it, int64 readback included.
    fetch = rand((BATCH * (32 + SHARD),), rng)
    rows = hh._rows(fetch, 32, 32 + SHARD, BATCH, SHARD)
    hh._rows(fetch, 0, 32 + SHARD, BATCH, 32).copy_(hash_fn(rows))
    warm_ms = time_graph(hash_fn, [rows], 200)
    verify_ms = time_calls(lambda x: hh.verify_frames(x, BATCH, SHARD),
                          [fetch], 200)
    warm_bound = 1e3 * BATCH * (SHARD + 32) / HBM_BYTES_PER_S
    # The grouped verify at a GET fetch's shape: K readers' BATCH frames
    # in one launch (its int64 answers stay on the card; the reader reads
    # them back with one sync).
    group = BATCH * (32 + SHARD)
    gfetch = rand((K * group,), rng)
    for g in range(K):
        hh._rows(gfetch, g * group, 32 + SHARD, BATCH, 32).copy_(
            hh.hash256_pitched(gfetch, g * group + 32, 32 + SHARD, BATCH,
                               SHARD))
    grouped_ms = time_graph(
        lambda x: hh.verify_frames_grouped(x, K, group, BATCH, SHARD),
        [gfetch], 200)
    grouped_bound = 1e3 * K * group / HBM_BYTES_PER_S
    log(f"highwayhash256 [{BATCH * (K + M)}, {SHARD}] cold: {hh_ms:.5f} ms, "
        f"{1e6 * hh_ms / packets:.2f} ns/packet; [{BATCH}, {SHARD}] warm: "
        f"{warm_ms:.5f} ms, {1e6 * warm_ms / packets:.2f} ns/packet; verify "
        f"of {BATCH} frames warm, a call from Python with its int64 "
        f"readback: {verify_ms:.5f} ms; grouped verify of {K} x {BATCH} "
        f"frames: {grouped_ms:.5f} ms a launch (bound {grouped_bound:.5f} "
        "ms)")
    return [
        {"name": "gf_apply", "route": "cuda",
         "source": "minio_tpu_torch/csrc/gf_apply.cu",
         "replaces": "minio_tpu/ops/rs_pallas.py:59",
         "also_replaces": "minio_tpu/ops/rs.py:29",
         "checked": True, "launches": sum(launches["gf_apply"].values()),
         "launches_by_path": launches["gf_apply"],
         "launches_4j_by_shape": launches["gf_by_shape"],
         "max_abs_err": errs["gf_apply"], "ms": gf_ms,
         "call_ms": gf_call_ms, "plain_ms": gf_plain_ms, "bound_ms": gf_bound,
         "bound_by": "bytes" if gf_bytes / HBM_BYTES_PER_S
         >= gf_ops / INT8_OPS_PER_S else "operations",
         "library_ms": None, "shape": [BATCH, K, SHARD],
         "codec_shapes": codec_shapes, "heal_shapes": heal_shapes},
        {"name": "highwayhash256", "route": "cuda",
         "source": "minio_tpu_torch/csrc/highwayhash.cu",
         "replaces": "minio_tpu/ops/highwayhash_jax.py:279",
         "checked": True,
         "launches": sum(launches["highwayhash256"].values()),
         "launches_by_path": launches["highwayhash256"],
         "max_abs_err": max(errs["highwayhash256"], errs["hh256_verify"],
                            errs["hh256_verify_grouped"]),
         "ms": hh_ms, "plain_ms": hh_plain_ms, "bound_ms": hh_bound,
         "bound_by": "bytes", "library_ms": None,
         "shape": [BATCH * (K + M), SHARD],
         "ns_per_packet": 1e6 * hh_ms / packets,
         "warm_ms": warm_ms, "warm_shape": [BATCH, SHARD],
         "warm_bound_ms": warm_bound,
         "warm_ns_per_packet": 1e6 * warm_ms / packets,
         "verify_warm_ms": verify_ms,
         "verify_grouped_ms": grouped_ms,
         "verify_grouped_shape": [K, BATCH, SHARD],
         "verify_grouped_bound_ms": grouped_bound},
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from minio_tpu_torch.ops import _build  # fails outside the repo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.3f} s")
    for name, text in _build.BUILD_LOGS.items():
        log(f"--- nvcc -Xptxas -v: {name}.cu ---\n{text.strip()}")

    rng = np.random.default_rng(1234)
    errs = check_kernels(rng)
    log(f"heap: {len(gc.get_objects())} objects tracked by the collector "
        "before the main paths")
    settle_heap()
    gc.callbacks.append(on_gc)
    launches = run_main_path()
    trace_path("put_get_heal", traced_put_get_heal)
    t0 = time.perf_counter()
    object_line, object_launches = run_object_layer()
    log(f"object layer phase {time.perf_counter() - t0:.1f} s")
    object_line["trace"] = trace_path("object layer", traced_object_layer)
    t0 = time.perf_counter()
    s3_line, s3_launches = run_s3_plane()
    log(f"S3 plane phase {time.perf_counter() - t0:.1f} s")
    s3_line["trace"] = trace_path("s3 plane", traced_s3_plane)
    t0 = time.perf_counter()
    drivers_line = run_drivers()
    log(f"driver comparison phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    codecs_line, codec_launches = run_codecs()
    log(f"codec phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    core_line, core_launches = run_s3_core()
    log(f"S3 object core phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    heal_line, heal_launches, system_objects = run_self_heal()
    log(f"self-heal phase {time.perf_counter() - t0:.1f} s")
    check_system_object_kernels(rng, errs, system_objects)
    heal_line["trace"] = trace_path("self heal", traced_self_heal)
    by_path = {name: {"put_get_heal": launches[name],
                      "object_layer": object_launches[name],
                      "s3_plane": s3_launches[name],
                      "codecs": codec_launches[name],
                      "s3_core": core_launches[name],
                      "self_heal": heal_launches[name]}
               for name in launches}
    by_path["gf_by_shape"] = heal_line["gf_apply_by_shape"]
    gc.callbacks.remove(on_gc)
    log(f"collector passes over 20 ms in the main paths (generation, s): "
        f"{PAUSES}")
    log(f"hedge windows restarted after an oversleeping wait: {RESTARTS}")
    drivers_line["collector_pauses"] = PAUSES
    drivers_line["hedge_windows_restarted"] = RESTARTS
    kernels = time_kernels(rng, by_path, errs)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"object_layer": object_line}), flush=True)
    print(json.dumps({"s3_plane": s3_line}), flush=True)
    print(json.dumps({"pipelined": drivers_line}), flush=True)
    print(json.dumps({"codecs": codecs_line}), flush=True)
    print(json.dumps({"s3_core": core_line}), flush=True)
    print(json.dumps({"self_heal": heal_line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

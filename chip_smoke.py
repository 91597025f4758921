"""Smoke run of minio_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught):
 1. the card's name and power limit, the torch and CUDA versions;
 2. build every kernel source of minio_tpu_torch/csrc (gf_apply.cu,
    highwayhash.cu, aes_gcm.cu; one nvcc each, all at once) for sm_90a
    and print ptxas's register/shared-memory report;
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
    first and last chunks in several groups); kernels C and D
    (AES-256-GCM seal and open, check_aes_kernels) against the plain
    version at plaintext lengths 0, 1, 15, 16, 17, 12,345 and 65,536
    with AADs of 3 B, 8 B and a KMS context, at batches of 1, 16, 33,
    127, 256 and 4,097 packages, at the cluster edges (GHASH sequences
    ending on a multiple of a cluster's threads and one block either
    side, alone and in launches of 64 and 127 where every package has a
    different length, zero-length and AAD-only packages among them),
    with flipped nonce, ciphertext, tag and AAD bytes at 16 and 127
    packages (the ok flags false exactly there, those packages'
    plaintext zero), captured with their workspace in a CUDA graph, and
    at known answers made with the `cryptography` package; kernels E and
    F (snappy compression and framed-chunk decompression with CRC32C,
    check_s2_kernels) against the plain codec, exact: every block, CRC
    and length of E and every raw byte and status of F, in batches of 1,
    33, 128 and 4,097 chunks cycling through 64 KiB of phase 4n's seeded
    text, random bytes (blocks longer than the chunk) and zeros, the
    12,345 B tail, lengths 0 to 8, tests/test_s2.py's copy-remainder
    runs, periodic chunks, a first match at lane 31 of E's window and
    chunks of 9, 31 and 40 B, and F on a flipped CRC byte (status 1) and
    a truncated block (status 2);
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
    byte healed with no fallback, the pacer's grants, one a heal, and
    the window's heals by the thread that ran them), every file of d8
    back. Two scanner cycles (its loop stopped): usage equal
    to the admin datausage walk, the second skipping through the update
    tracker every bucket the first's sampled heals (1 object in 512) did
    not touch, the admin usage snapshot over HTTP. Kernel A's
    wrapper also counts its launches by shape. Prints {"self_heal": ...};
    one traced run (object_self_heal at 64 MiB + 12,345 B) gives the idle
    share. 3b: kernel A and B at the shard lengths of the objects the
    server wrote under .minio.sys, known only after the run;
 4k. server-side encryption over HTTP (entry.s3_sse): a Server over 16
    drive directories (one 12+4 set, 1 MiB blocks), its S3 plane alone,
    MTPU_ALLOW_INSECURE_SSEC=1 (no TLS), a KMS key made through the
    admin route; for each of SSE-S3, SSE-C and SSE-KMS a 256 MiB +
    12,345 B object (4,097 packages, 268,562,517 B stored) PUT streamed,
    GET and a ranged GET (exact bytes, compared piece by piece), HEAD
    with the SSE answers, drives 0, 5, 12 and 15 lost, a degraded GET,
    HealObject (every xl.meta and part file equal to its original),
    a GET again; then a CopyObject SSE-C -> SSE-S3 and a GET of it, and
    a GET with a wrong SSE-C key (AccessDenied). Counters zeroed just
    before and read just after; each PUT must launch kernel C, each GET
    kernel D, each heal kernels A and B and never C or D. Prints each
    step's seconds, GB/s of logical object and launches, the peak
    resident-set growth of each PUT and GET, and {"sse": ...};
 4l. admission and drive health over HTTP (entry.admission_drive_health):
    a Server over 16 drive directories (one 12+4 set, 1 MiB blocks,
    dense-gf8), its S3 plane alone, every drive under the health wrapper
    with per-op deadlines of 1 s (2 s for long ops), a breaker threshold
    of 3 and a probe every 0.5 s, the governors pinned. a: the hot key's
    6 PUTs of 64 MiB + 12,345 B against 2 encode slots (client cap 2,
    queue 16), the quiet key's one PUT queued behind them: the grant
    order (a probe on the governor) must be hot, hot, hot, quiet, hot,
    hot, hot, every object read back exactly, each GET's decode slot
    charged to its caller, arrivals = admitted + rejected - late grants;
    b: queue 2, the PUTs past it answered 503 SlowDown at once with
    nothing stored; with the read governor saturated a GET answered 503
    SlowDown before its status line; MTPU_ADMISSION_TENANT=bucket giving
    a second bucket of the same key the second turn; c: drive d6 stalled
    on every op (installed before the server's first op): a degraded GET
    (kernel A) and a 256 MiB + 12,345 B PUT at write quorum, each before
    and after the breaker latches (after it: ErrDiskFaulty at once, no
    deadline paid), the stall lifted and the drive let back in by the
    probe; d: the admin heal of c under a foreground backlog of 2
    (pacer yields, every heal granted by its max wait; d6's rebuilt part
    files equal by SHA-256 to those written while it was healthy), a
    heal with no backlog granted at once, the pacer's window fed by the
    wrapper. Kernel B launches in every step, A in the degraded GETs
    and the heal, C and D nowhere. Prints {"admission": ...} with each
    step's seconds and launches, the grant orders, the governors' and
    drives' health snapshots and the pacer's counters;
 4m. the observability plane over HTTP (entry.observability): a Server
    over 16 drive directories (one 12+4 set, 1 MiB blocks), its S3 plane
    alone, spans armed with every request captured (MTPU_TRACE_SLOW_MS
    0): the health probes with every drive up; a 256 MiB + 12,345 B PUT
    and GET; the object lost on drives 0, 5, 12 and 15 and those drives
    offline, a degraded GET (ready still 200); the drives back, the
    admin heal (every healed file equal by SHA-256); an SSE-S3 PUT and
    GET of the same size; the four drives offline again and a fifth:
    live 200, ready and cluster 503, then 200 again with the fifth and
    all back; the node and cluster scrapes (every series in the port's
    catalog) and the admin ioflow and slow-requests answers. Counters
    zeroed just before and read just after; kernels A and B launch in the
    PUT, the degraded GET and the heal, C in the SSE PUT, D in the SSE
    GET, no read is hedged, every step's request trees are whole (each
    span's parent in the tree, none cut at the cap), and the byte-flow
    ledger equals the drives' bytes: the PUT's part files and xl.meta,
    the twelve survivors' part files the degraded GET and the heal read,
    the four part files and xl.meta the heal wrote. Prints each step's
    seconds and launches, each tree's seconds by span kind, the ledger's
    bytes by op class and direction, the scraped series and the health
    codes; then the span plane's cost: phase 4e with the plane armed and
    disarmed (MTPU_TRACE unset / 0), on then off, with 64 small objects,
    each call's seconds, each run from a fresh heal pacer. Prints
    {"observability": ...};
 4n. the config subsystem and compression over HTTP
    (entry.config_compression): a Server over 16 drive directories (one
    12+4 set, 1 MiB blocks), its S3 plane alone: `compression enable=on
    extensions=.log` and `storage_class rrs=EC:2` set over the admin route
    (each save sealed by kernel C, the history two entries longer); a
    256 MiB + 12,345 B .log object of seeded text PUT compressed (E, A,
    B; its stored size and ratio printed), GET whole and a 3 MiB range
    from its middle (B, F), each equal by SHA-256; the object lost on
    drives 0, 5, 12 and 15 and those drives offline, a degraded GET (A,
    B, F); the drives back, the admin heal (A and B, never E or F; every
    healed file equal by SHA-256); the same text as SSE-S3 (E, C, A, B;
    then B, D, F); 16 MiB of random bytes as .log stored unmarked after
    E's one probe launch; a REDUCED_REDUNDANCY object at 14+2 (kernel A
    at 2x14); `api requests_max=1 requests_deadline=1s` set, the server
    built again on the same drives (the config loads: D), the compressed
    object read back, and a GET while the one slot is held answered 503
    SlowDown. Counters zeroed just before and read just after each step;
    prints each step's seconds and launches and {"config_compression":
    ...};
 4o. object lock, the bucket quota and lifecycle expiry over HTTP
    (entry.s3_lock_quota_lifecycle): a Server over 16 drive directories
    (one 12+4 set, 1 MiB blocks), its S3 plane alone. A WORM bucket
    (versioning, COMPLIANCE default retention of a day): two versions of
    one key of 256 MiB + 12,345 B (A, B), v1's DELETE by id answered 403
    with no file of the key changed, a DeleteObjects naming v1 answered
    with its Error, a DELETE writing a marker, v1's retention lengthened
    (200) and shortened (403), v1 read degraded with drives 0, 5, 12 and
    15 offline and the key lost there (A, B; exact by SHA-256), each
    version healed (A, B; part files equal, version journals equal), a
    2 x 16 MiB multipart object under the default retention. GOVERNANCE
    and legal hold: 16 MiB versions deleted 403 then 204 with the bypass
    header, and 403 under the hold, 204 after ?legal-hold OFF, its files
    gone from every drive. A 300 MiB hard quota set and read back over
    the admin route, a 256 MiB + 12,345 B PUT, a 64 MiB PUT and a 64 MiB
    UploadPart each answered 409 QuotaExceeded from their headers (no
    kernel launch, no drive file changed), one scanner cycle after which
    the quota reads the scanner's usage, the quota cleared and the 64 MiB
    PUT stored. Lifecycle: an unversioned bucket expiring logs/ after a
    day (a 256 MiB + 12,345 B logs/ object, a keep/ object, an open
    upload) and a versioned one expiring noncurrent versions beyond the
    newest and orphan markers (three 16 MiB versions, an orphan marker);
    the scanner's lifecycle steps called with now two days ahead, then
    one real scan cycle: the logs/ object gone from every drive, keep/
    unchanged, the oldest noncurrent version gone, the marker and the
    upload gone, ilm_expired_total 3 in a cluster scrape. Counters zeroed
    just before and read just after each step; the .minio.sys objects it
    wrote then checked as phase 3b checks 4j's. Prints each step's
    seconds and launches and {"lock_quota_lifecycle": ...};
 4p. remote tiers over HTTP (entry.s3_tiering): two Servers on the card
    in this process, a hot one over 16 drive directories (one 12+4 set,
    1 MiB blocks, compression on for .log) and a cold one over 16 others
    holding the bucket coldstore, each with its S3 plane alone. The admin
    add-tier of COLD (coldstore under the prefix tiered; list-tiers
    without the secret key), three seeded objects (256 MiB + 12,345 B
    plain, the same SSE-S3, 64 MiB of 4n's text compressed then sealed),
    a ?lifecycle Transition after a day to COLD, and the scanner's
    lifecycle step with now two days ahead: every object transitioned
    (no hot part file left, every hot xl.meta keeping its version with
    the tier markers, coldstore holding the stored sizes, no 64-byte run
    of plaintext in either SSE copy, ilm_transitioned_total 3); each
    object's GET and HEAD with x-amz-storage-class COLD and a 3 MiB range
    from its middle, exact by SHA-256 (B on the cold server, D and F on
    the hot); the plain object's remote copy lost on cold drives 0, 5, 12
    and 15 and those drives offline, its GET exact (A rebuilds on the
    cold server), then the copy healed there; POST ?restore (202, each
    hot drive's part file equal to its own before the transition, the
    GET with x-amz-restore); the scanner's step with now three days
    ahead dropping the restored copy (ilm_restored_total 1, the GET from
    the tier exact); an admin heal with remove=true keeping all three
    tiered versions and rebuilding a lost hot xl.meta; remove-tier COLD
    refused while the lifecycle names it. Counters zeroed just before
    and read just after each step; then phase 3c (check_tier_kernels)
    holds the kernels to their plain versions at the shapes known only
    after the run: the cold server's reconstructions, the stored sizes
    and .minio.sys objects of both servers, and C, D, E and F at every
    package and chunk count 4p launched them with. Prints each step's
    seconds, launches and the hot TierEngine's seconds by part (local
    read, SigV4 hash, send, commit, fetch, restore write, inversion),
    and {"tiering": ...};
 4q. identity over HTTP (entry.s3_identity): a Server over 16 drive
    directories (one 12+4 set, 1 MiB blocks), its S3 plane alone, with
    identity_openid (an HS256 secret and the JWKS of an RSA key made
    here from a seed, Python integers) and identity_ldap (a toy LDAP
    directory in this process) in the environment. The root adds the
    canned policy idp-rw (PutObject, GetObject, ListBucket on bucket
    idp), the user alice and the mappings of alice and ldap:bob over the
    admin routes, each a .minio.sys PUT (A, B); list-users shows alice
    with idp-rw. Alice PUTs 256 MiB + 12,345 B to idp (A, B) and GETs it
    exact (B); her PUT to idp-other is answered 403 with no launch and
    no drive file changed. AssumeRole by alice with a session policy of
    s3:GetObject alone: the temporary credential's GET with its token
    exact (B), its PUT 403, its GET without the token 403
    InvalidTokenId. AssumeRoleWithWebIdentity with an HS256 and an RS256
    token (policy=idp-rw); the RS256 credential's SSE-S3 PUT (A, B, C)
    and GET (B, D) exact. AssumeRoleWithLDAPIdentity for bob (a wrong
    password 403); the object lost on drives 0, 5, 12 and 15 and those
    drives offline, bob's degraded GET exact (A, B). A service account
    of alice's made in process: its 3 MiB ranged GET exact, its PUT
    outside idp 403. Form uploads of 16 MiB signed by alice answered 201
    and 204 (A, B), each GET exact; a form breaking its starts-with
    condition 403 with no launch. The IAM blobs lost on the same four
    drives, the server built again with them offline: the IAM loads
    from the degraded blobs (A), alice's and the service account's keys
    answer, every STS credential is gone; the drives back, the admin
    heal of idp and the IAM blobs' heals leave every healed file equal
    by SHA-256. Counters zeroed just before and read just after each
    step; then phase 3d (check_identity_kernels) holds kernel A to its
    plain version at the object's and each IAM blob's reconstructions,
    A and B at the .minio.sys objects' shard lengths, C and D at any
    package count phase 3 did not cover. Prints each step's seconds and
    launches and {"identity": ...};
 5. time each kernel at the main shapes with CUDA events (kernel B cold
    at the PUT shape [128, 87382] and L2-warm at the GET shape
    [8, 87382], in ns per packet too, and its grouped verify at a fetch
    of 12 readers x 8 frames; kernel A also at 4h's msr-pm encode
    shapes [8, 24, 43,691] -> 8 and [8, 64, 16,384] -> 64, and at 4j's
    heal shapes, the one-target reconstruction [8, 12, 87,382] -> 1 and
    the msr-pm repair window [5, 16, 43,691] -> 2; kernels C and D at
    every launch shape of 4k: the 32-byte key seal, 16, the closing 33,
    127 (the port's batch) and 4,097 packages, each with its share of
    the bound and its launches in 4k; kernels E and F at 1, 128 and 4,097
    chunks of 4n's text against their byte bound, with their launches in
    4n) and print one JSON line {"kernels": [...]}, whose launches are
    those of phases 4, 4c, 4e, 4h, 4i, 4j, 4k, 4l, 4m, 4n, 4o, 4p and 4q
    (by path in "launches_by_path"; E's and F's those of 4n); every
    kernel must have launched on the main paths;
 6. print the device JSON as the last line.

It exits non-zero without a result when no CUDA card is available.
"""

from __future__ import annotations

import gc
import json
import shutil
import struct
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
ADMISSION_SIZE = (64 << 20) + 12_345
LQL_SMALL = 16 << 20     # phase 4o's versions, parts and small objects
LQL_REFUSED = 64 << 20   # 4o's PUT and UploadPart past the quota
LQL_QUOTA = 300 << 20    # 4o's hard quota
TIER_TEXT_SIZE = 64 << 20  # 4p's compressed-then-sealed object
IDP_POST_SIZE = 16 << 20   # 4q's form uploads
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
# 32-bit integer operations: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
# (H100 SXM; NVIDIA's Hopper white paper).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# The least 32-bit operations a 16-byte AES-GCM block needs: 14 rounds of
# 16 table lookups, each with its XOR, and GHASH's product as 32 nibble
# steps of two lookups and two XORs.
AES_GCM_OPS_PER_BLOCK = 14 * 16 * 2 + 32 * 4
# Phase 3 of kernels C and D: plaintext lengths (32: an object key or a
# KMS data key), AADs (minio_tpu's: a package's <Q sequence number,
# b"OEK" of an object-key seal, a KMS context), batches of 64 KiB
# packages, the last 12,345 B: 1 MiB, 4k's closing launch of 32 full
# packages and the tail, and the 256 MiB + 12,345 B object's 4,097; the
# port's own batch (packages_per_launch) is added where it runs.
AES_LENGTHS = (0, 1, 15, 16, 17, 32, 12_345, 65_536)
AES_AADS = (b"OEK", struct.pack("<Q", 7),
            json.dumps({"bucket": "smoke"}, sort_keys=True).encode())
AES_BATCHES = (1, 16, 33, 256, 4097)
PACKAGE = 64 << 10
# AES-256-GCM known answers (key, nonce, plaintext, AAD, ciphertext ||
# tag), made with the `cryptography` package's AESGCM; the card's machine
# has no such package, so these hold kernels C and D to it directly.
AES_GCM_KAT = (
    ("1477b739cbad978d79979138218bd7308ebd0b8cd5a499e19aef425fe8b61728",
     "e25b2ce1ae867c17a9e6025f",
     "",
     "",
     "8725d1d22699b7cb29bea268002d81f7"),
    ("baf3a8c3e0dd35c6e0ef9609d336e2824dd7a184102cd0593a117dd5853bb3ad",
     "c72ff7d560430f7e743f0185",
     "54",
     "4f454b",
     "db7cdcbfb2680ad74d0ab9605b7c1a86ba"),
    ("4b58845427d9ab405efdd687911636bf0237b27cb01042f2231e2be89a30754a",
     "71507c78789e5b0943aafac8",
     "15785b95db1d8c2a6845c4a2351bfed8e5",
     "0500000000000000",
     "8be36f0658fec76ab8903652abd6dab728cc32820b6e59137d106e6d81e73ba0c7"),
    ("e1bcb446e8c9d9fff7e0eb5d5a12b0c1590e2ada4c0fa21dda894dc27ef6f17b",
     "34ac0f252ca4179dd44be880",
     "288946f3b5040e8a41ae8507e452ef0b5ebbd17e6a5935a40dde95efd3f5eac8"
     "288946f3b5040e8a41ae8507e452ef0b5ebbd17e6a5935a40dde95efd3f5eac8",
     "7b226275636b6574223a2022736d6f6b65227d",
     "b0870b7bc4cfd14004c0a25a683b4d62925399a0e30accbcbb02e84dea5ede8a"
     "00292b9e86bd0e4dd562201ae6a9741a2cc221066f909891ccb20e331833ee59"
     "d62b67cb41a8862d09bb92cc72c2f4b2"),
    ("81179e1703e0609de8a1a5e9e702d0283dc2c06ba75baa0349bb654f883193ed",
     "da64e05495ed3f63886b5393",
     "54b2acf6e544a610d9cfa218141b9fcf4ebdd4e1cae6f369ef995635bc2f06d2"
     "54b2acf6e544a610d9cfa218141b9fcf4ebdd4e1cae6f369ef995635bc2f06d2"
     "54b2acf6e544a610d9cfa218141b9fcf4ebdd4e1cae6f369ef995635bc2f06d2"
     "54b2acf6",
     "",
     "441e327b42a808a6fe2890cdae910aefc3dc741d18da4cd175307ebb457175df"
     "d38e144c06773ca94f7eb8e67c4fef109ab858a2c61b5ef3f31d762fd2d0dbfd"
     "867b4b7ff00ca19b70a6eaddb34bfad8f5ecd4e27a70ca273464559aef03f7b5"
     "58a2b54398f43f6e8d3bacc47a4edfa6190cffac"),
)


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
    4b, 4c, 4d, 4e, 4f, 4i, 4k, 4l, 4m, 4o and 4p store (an inline or
    small object is one short block; 4i's UploadPartCopy parts end in 7 B
    and 12,338 B; an encrypted object's stored size is its plaintext's
    plus 28 B a 64 KiB package; 4l's and 4o's refused writes are never
    encoded; 4o's 16 MiB and 64 MiB objects and parts are whole blocks;
    4p's plain and SSE-S3 objects have 4k's sizes, on both servers, and
    its compressed-then-sealed object's size is known after the run:
    phase 3c checks it)."""
    from minio_tpu_torch.crypto.sse import encrypted_size
    from minio_tpu_torch.entry import part_copy_ranges

    core_parts = [last - first + 1
                  for first, last in part_copy_ranges(OBJECT_SIZE)]
    lengths = set()
    for size in (OBJECT_SIZE, TRACE_SIZE, INLINE_SIZE, MP_PART, MP_LAST,
                 *SMALL_SIZES, *core_parts, CORE_SMALL_SIZE,
                 ADMISSION_SIZE, encrypted_size(OBJECT_SIZE)):
        if size >= BLOCK:
            lengths.add(SHARD)
        if size % BLOCK:
            lengths.add(-(-(size % BLOCK) // K))
    return sorted(lengths)


def path_reconstructions() -> list[tuple[tuple, tuple]]:
    """(unavailable shards, rebuilt shards) of every reconstruction the
    main paths run: phase 4's and 4c's heal (shards 0, 5, 12, 15 lost),
    degraded GET (data shards 0 and 5 rebuilt, shard 12 gone) and GET
    past a flipped byte (data shard 3 rebuilt); and phases 4e's, 4i's,
    4k's and 4m's, whose lost shards are those that drives 0, 5, 12 and
    15 hold for each object, through its distribution: the heal rebuilds
    them all, a degraded GET (4e's big objects, 4i's versions of ver/big
    and the copies' pulls from them, 4k's encrypted objects, 4m's plain
    one, 4o's WORM key read by version) the data shards among them.
    4p's reconstructions run on its cold server, under a key that holds a
    uuid: phase 3c checks them after the run."""
    from minio_tpu_torch.entry import (OBS_BUCKET, OBS_OBJECT, S3_BUCKET,
                                       S3_WIPED, SSE_MODES,
                                       lock_quota_lifecycle_keys,
                                       s3_object_names)
    from minio_tpu_torch.object.metadata import hash_order

    recs = {(LOST, LOST), (LOST, (0, 5)), ((3,), (3,))}
    keys = [(f"{S3_BUCKET}/{name}", n < 2)
            for n, name in enumerate(s3_object_names(SMALL_COUNT))]
    keys += [(f"{b}/{name}", b == "ver") for b, name in CORE_OBJECTS]
    keys += [(f"{S3_BUCKET}/sse/{mode}.bin", True) for mode in SSE_MODES]
    keys += [(f"{OBS_BUCKET}/{OBS_OBJECT}", True)]
    keys += lock_quota_lifecycle_keys()
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


def codec_lengths(erasure, sizes, full: bool = True) -> list[int]:
    """The shard lengths objects of `sizes` bytes give the kernels under
    `erasure`'s codec, rounded to its sub-packetization: each last
    block's, and a full block's unless `full` is false."""
    lengths = {erasure.chunk_size(s % BLOCK) for s in sizes if s % BLOCK}
    if full:
        lengths |= {erasure.chunk_size(min(s, BLOCK)) for s in sizes}
    return sorted(lengths - {0})


def check_system_object_kernels(rng, errs: dict, sizes: dict) -> None:
    """Phase 3b, after phase 4j: the objects the server wrote under
    .minio.sys (the scanner's usage, the update tracker's filter, bucket
    metadata, IAM blobs) have sizes known only after the run. Kernel A's
    encode under each codec the server may pick (dense-gf8, cauchy-xor,
    msr-pm in its sub-shard view), and kernel B's hash and grouped
    verify, at their shard lengths, exact."""
    from minio_tpu_torch.erasure import registry
    from minio_tpu_torch.erasure.codec import cached_erasure
    from minio_tpu_torch.ops import highwayhash_torch as hh

    lengths = set()
    for codec in SELF_HEAL_CODECS:
        erasure = cached_erasure(K, M, BLOCK, codec, "cuda")
        a = erasure.subshards
        code_lengths = codec_lengths(erasure, sizes.values(), full=False)
        lengths.update(code_lengths)
        mat = registry.get(codec).parity_matrix(K, M)
        err = gf_matrix_err(rng, errs, mat,
                            [(1, K * a, ln // a) for ln in code_lengths])
        log(f"gf_apply {codec} encode at the .minio.sys objects' shard "
            f"lengths {code_lengths} ({sizes}): max_abs_err {err}")
    for ln in sorted(lengths):
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


def reconstruct_errs(rng, errs: dict, unavailable, targets, sizes,
                     batches, label: str) -> None:
    """Kernel A against its plain version at the reconstruction of
    `targets` from the first K shards not `unavailable`, under each
    codec the server may pick (its auto choice is a probe of the process,
    and a phase's objects take whichever won), at the shard lengths of
    objects of `sizes` bytes, B in `batches`."""
    from minio_tpu_torch.erasure import registry
    from minio_tpu_torch.erasure.codec import cached_erasure

    present = [i for i in range(K + M) if i not in unavailable]
    for codec in SELF_HEAL_CODECS:
        erasure = cached_erasure(K, M, BLOCK, codec, "cuda")
        a = erasure.subshards
        shapes = [(b, K * a, ln // a) for ln in codec_lengths(erasure, sizes)
                  for b in batches]
        mat = registry.get(codec).reconstruct_matrix(K, M, present,
                                                     list(targets))
        err = gf_matrix_err(rng, errs, mat, shapes)
        log(f"gf_apply {label} {codec} reconstruct 12+4 {list(targets)} "
            f"from {present[:K]} at {shapes}: max_abs_err {err}")


def aes_phase3_counts() -> set:
    """The package counts phase 3 launches kernels C and D with."""
    from minio_tpu_torch.api.transforms import packages_per_launch

    return {*AES_BATCHES, packages_per_launch("cuda"), 1, 16, 64,
            len(AES_LENGTHS) * len(AES_AADS)}


def check_tier_kernels(rng, errs: dict, res: dict, aes_counts: dict,
                       s2_counts: dict) -> None:
    """Phase 3c, after phase 4p: the shapes 4p gave the kernels that are
    known only after its run, exact. Kernel A's reconstructions on the
    cold server (the remote copy's key holds a uuid, and with it which
    shards cold drives 0, 5, 12 and 15 hold) at B = 1 and 8 and every
    shard length of the plain object, under each codec
    (reconstruct_errs); kernels A and B at the stored sizes
    (the compressed-then-sealed object's depends on its text) and at the
    .minio.sys objects' of both servers (check_system_object_kernels);
    C and D at each package count, and E and F at each chunk count, that
    4p launched them with and phase 3 did not."""
    for unavailable, targets in res["cold_reconstructions"]:
        reconstruct_errs(rng, errs, unavailable, targets, [res["size"]],
                         (1, BATCH), "4p cold")
    sizes = dict(res["system_objects"])
    sizes.update({f"stored {n}": v for n, v in res["stored_sizes"].items()})
    check_system_object_kernels(rng, errs, sizes)
    key = rng.bytes(32)
    counts = {int(p) for name in ("aes_gcm_seal", "aes_gcm_open")
              for p in aes_counts[name]} - aes_phase3_counts()
    for p in sorted(counts):
        lengths = [PACKAGE] * (p - 1) + [12_345]
        aads = [struct.pack("<Q", i) for i in range(p)]
        aes_case(key, aes_batch(rng, lengths, aads), f"4p batch {p}", errs)
    chunks = {int(n) for name in ("s2_compress", "s2_decompress")
              for n in s2_counts[name]} - set(S2_BATCHES)
    if chunks:
        pool = s2_pool(rng)
        plain = s2_plain(pool)
        for n in sorted(chunks):
            s2_batch_case(pool, plain, n, errs)
    log(f"4p's own counts: C/D at {sorted(counts)} packages, E/F at "
        f"{sorted(chunks)} chunks (the rest phase 3 covers)")
    bad = {k: v for k, v in errs.items() if v != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"at 4p's shapes: {bad}")


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
    check_aes_kernels(rng, errs)
    check_s2_kernels(rng, errs)
    bad = {k: v for k, v in errs.items() if v != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    return errs


def aes_batch(rng, lengths, aads):
    """Packages of random plaintext on the card, back to back, with
    random nonces and the given AADs: (seal descriptor, plaintext,
    nonces [P, 12], AADs, wire size)."""
    from minio_tpu_torch.ops.aes_gcm import OVERHEAD, seal_desc

    desc = seal_desc(lengths, [len(a) for a in aads])
    p, n = len(desc), int(desc[:, 1].sum())
    aad = torch.from_numpy(np.frombuffer(b"".join(aads), dtype=np.uint8)
                           .copy()).cuda()
    return (torch.from_numpy(desc).cuda(), rand((n,), rng),
            rand((p, 12), rng), aad, n + OVERHEAD * p)


def aes_case(key: bytes, batch, label: str, errs: dict,
             flips=()) -> None:
    """Kernel C against the plain seal, then kernel D against the plain
    open on the kernel's wire with the bytes of `flips` (package, part)
    flipped, part one of nonce, ct, tag, aad: the ok flags must be false
    exactly at the flipped packages, and where none is flipped the
    plaintext must come back whole."""
    from minio_tpu_torch.ops import aes_gcm as plain, aes_gcm_cuda as kc

    desc, data, nonces, aad, n = batch
    wire = kc.seal_cuda(key, data, desc, nonces, aad, n)
    want = plain.seal_plain(key, data, desc, nonces, aad, n)
    torch.cuda.synchronize()
    seal_err = max_abs_err(wire, want)
    odesc = plain.open_desc(desc)
    aad = aad.clone()
    rows = desc.cpu().numpy()
    for pkg, part in flips:
        in_off, ln, aad_off, _, out_off = (int(v) for v in rows[pkg])
        pos = {"nonce": out_off + 5, "ct": out_off + 12 + ln // 2,
               "tag": out_off + 12 + ln + 15}.get(part)
        if pos is None:
            aad[aad_off] ^= 1
        else:
            wire[pos] ^= 0x80
    got, ok = kc.open_cuda(key, wire, odesc, aad, data.numel())
    want_pt, want_ok = plain.open_plain(key, wire, odesc, aad, data.numel())
    torch.cuda.synchronize()
    open_err = max_abs_err(got, want_pt)
    flags = ok.bool().cpu().tolist()
    expect = [i not in {f[0] for f in flips} for i in range(len(rows))]
    if flags != expect or want_ok.cpu().tolist() != expect:
        raise AssertionError(f"aes_gcm {label}: ok flags {flags}, plain "
                             f"{want_ok.cpu().tolist()}, want {expect}")
    if not flips and not torch.equal(got, data):
        raise AssertionError(f"aes_gcm {label}: open did not give the "
                             "plaintext back")
    log(f"aes_gcm {label}: seal max_abs_err {seal_err}, open max_abs_err "
        f"{open_err}, ok flags as expected")
    errs["aes_gcm_seal"] = max(errs["aes_gcm_seal"], seal_err)
    errs["aes_gcm_open"] = max(errs["aes_gcm_open"], open_err)


def aes_edge_lengths(cluster: int) -> list[int]:
    """Plaintext lengths whose GHASH blocks, with an 8-byte AAD (one
    block) and the lengths block, end exactly on one and on two multiples
    of a cluster's threads (kernel C's and D's stride), and one block
    either side."""
    from minio_tpu_torch.ops import aes_gcm_cuda as kc

    ct = cluster * kc.THREADS
    return [16 * (m * ct + d - 2) for m in (1, 2) for d in (-1, 0, 1)]


def aes_edge_batch(packages: int) -> tuple[list[int], list[bytes]]:
    """A launch of `packages` packages, every one of a different length:
    the cluster edges of aes_edge_lengths() at the cluster size this
    launch takes (8-byte AADs), a zero-length package with no AAD, one
    with an AAD of 300 blocks and no message (the first blocks of its
    cluster see AAD only), then lengths 1 + 517 i with AES_AADS in turn."""
    from minio_tpu_torch.ops import aes_gcm_cuda as kc

    edges = aes_edge_lengths(kc.cluster_size(packages))[:packages]
    lengths = list(edges)
    aads = [struct.pack("<Q", i) for i in range(len(edges))]
    extra = [(0, b""), (0, bytes(range(256)) * 18 + bytes(192))]
    for ln, a in extra[:packages - len(lengths)]:
        lengths.append(ln)
        aads.append(a)
    i = 0
    while len(lengths) < packages:
        if 1 + 517 * i not in lengths:
            lengths.append(1 + 517 * i)
            aads.append(AES_AADS[i % len(AES_AADS)])
        i += 1
    if packages > 2 and len(set(lengths)) != packages - 1:  # two zeros
        raise AssertionError(f"edge batch lengths repeat: {lengths}")
    return lengths, aads


def aes_graph_case(key: bytes, batch, errs: dict) -> None:
    """Kernels C and D captured in one CUDA graph, each with the
    workspace it allocates, then replayed: equal to the plain seal and
    the plaintext back."""
    from minio_tpu_torch.ops import aes_gcm as plain, aes_gcm_cuda as kc

    desc, data, nonces, aad, n = batch
    odesc = plain.open_desc(desc)
    plen = data.numel()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kc.open_cuda(key, kc.seal_cuda(key, data, desc, nonces, aad, n),
                     odesc, aad, plen)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        wire = kc.seal_cuda(key, data, desc, nonces, aad, n)
        got, ok = kc.open_cuda(key, wire, odesc, aad, plen)
    wire.zero_()
    graph.replay()
    torch.cuda.synchronize()
    want = plain.seal_plain(key, data, desc, nonces, aad, n)
    err = max(max_abs_err(wire, want), max_abs_err(got, data))
    if not bool(ok.bool().all()):
        raise AssertionError("aes_gcm graph replay: a tag failed")
    log(f"aes_gcm seal and open in one CUDA graph ({desc.shape[0]} "
        f"packages): max_abs_err {err}")
    errs["aes_gcm_seal"] = max(errs["aes_gcm_seal"], err)
    errs["aes_gcm_open"] = max(errs["aes_gcm_open"], err)


def check_aes_kernels(rng, errs: dict) -> None:
    """Phase 3 for kernels C and D: every length of AES_LENGTHS with every
    AAD of AES_AADS in one batch; batches of AES_BATCHES full packages
    (the last 12,345 B) and one of the port's batch (all full) with <Q
    sequence AADs; the cluster edges (aes_edge_batch) alone and in
    launches of 64 and of the port's batch, every package of a different
    length; flipped nonce, ciphertext, tag and AAD bytes at 16 packages
    and at the port's batch; a seal and open captured in a CUDA graph;
    the known answers of AES_GCM_KAT."""
    from minio_tpu_torch.api.transforms import packages_per_launch
    from minio_tpu_torch.ops import aes_gcm_cuda as kc

    errs.update({"aes_gcm_seal": 0, "aes_gcm_open": 0, "aes_gcm_kat": 0})
    key = rng.bytes(32)
    pairs = [(ln, a) for ln in AES_LENGTHS for a in AES_AADS]
    aes_case(key, aes_batch(rng, [p[0] for p in pairs],
                            [p[1] for p in pairs]),
             f"lengths {AES_LENGTHS} x {len(AES_AADS)} AADs", errs)
    main = packages_per_launch("cuda")
    for p in sorted({*AES_BATCHES, main}):
        # 4k seals and opens its batches of `main` full packages.
        lengths = [PACKAGE] * (p - 1) + [PACKAGE if p == main else 12_345]
        aads = [struct.pack("<Q", i) for i in range(p)]
        aes_case(key, aes_batch(rng, lengths, aads), f"batch {p}", errs)
    for ln in aes_edge_lengths(kc.cluster_size(1)) + [0]:
        aes_case(key, aes_batch(rng, [ln], [b"OEK" if ln else b""]),
                 f"one package of {ln} B (cluster {kc.cluster_size(1)})",
                 errs)
    for p in (64, main):
        lengths, aads = aes_edge_batch(p)
        aes_case(key, aes_batch(rng, lengths, aads),
                 f"edge batch {p} (cluster {kc.cluster_size(p)}, lengths "
                 f"{lengths[:6]} at the edges)", errs)
    lengths = [PACKAGE] * 15 + [12_345]
    aads = [struct.pack("<Q", i) for i in range(16)]
    aes_case(key, aes_batch(rng, lengths, aads), "batch 16 tampered", errs,
             flips=((1, "nonce"), (4, "ct"), (9, "tag"), (13, "aad"),
                    (15, "ct")))
    aads = [struct.pack("<Q", i) for i in range(main)]
    aes_case(key, aes_batch(rng, [PACKAGE] * main, aads),
             f"batch {main} tampered", errs,
             flips=((0, "ct"), (5, "nonce"), (63, "tag"),
                    (main - 1, "aad")))
    aes_graph_case(key, aes_batch(rng, [PACKAGE] * 15 + [12_345],
                                  [struct.pack("<Q", i) for i in range(16)]),
                   errs)
    for i, (k, nonce, pt, aad, want) in enumerate(AES_GCM_KAT):
        k, nonce, pt, aad, want = (bytes.fromhex(x)
                                   for x in (k, nonce, pt, aad, want))
        dev = lambda b: torch.from_numpy(  # noqa: E731
            np.frombuffer(b, dtype=np.uint8).copy()).cuda()
        desc = torch.tensor([[0, len(pt), 0, len(aad), 0]],
                            dtype=torch.int64).cuda()
        wire = kc.seal_cuda(k, dev(pt), desc, dev(nonce).reshape(1, 12),
                            dev(aad), 28 + len(pt))
        got, ok = kc.open_cuda(k, dev(nonce + want), desc, dev(aad),
                               len(pt))
        torch.cuda.synchronize()
        good = (bytes(wire.cpu().numpy()) == nonce + want
                and bytes(got.cpu().numpy()) == pt and bool(ok[0]))
        errs["aes_gcm_kat"] = max(errs["aes_gcm_kat"], 0 if good else 1)
        log(f"aes_gcm known answer {i} ({len(pt)} B, AAD {len(aad)} B): "
            f"{'equal' if good else 'DIFFERENT'}")


# Phase 3 of kernels E and F: the batches (chunk counts) and the chunk
# contents, cycled through each batch: 64 KiB of phase 4n's seeded text at
# eight offsets, 64 KiB of random bytes (a block longer than the chunk)
# twice, 64 KiB of zeros, the object's 12,345 B tail, lengths 0 to 8,
# tests/test_s2.py's copy-remainder runs, and the hard cases of E's
# 32-position window: 64 KiB of periods 2, 3, 31, 32 and 33 (equal hashes
# on several lanes of a window) with a byte changed every 997, a chunk
# whose first match is found at lane 31, and chunks of 9, 31 and 40 B of
# three letters (a partial window at the limit); and text a third random,
# whose block is longer than kernel F stages. The plain codec is a
# Python loop, so it runs once a distinct chunk and the batches'
# expectations are assembled from those answers (chunks are independent).
S2_BATCHES = (1, 33, 128, 4097)
S2_RUNS = (65, 66, 67, 68, 129, 130, 131)
S2_PERIODS = (2, 3, 31, 32, 33)
S2_SHORT = (9, 31, 40)


def periodic_chunk(rng, period: int, size: int, every: int = 997) -> bytes:
    """`size` bytes repeating `period` random bytes, one byte in `every`
    changed: matches restart after each change inside periodic data."""
    out = bytearray((rng.bytes(period) * (size // period + 1))[:size])
    for i in range(every // 2, size, every):
        out[i] ^= 1 + int(rng.integers(255))
    return bytes(out)


def lane31_chunk(rng, tail: bytes) -> bytes:
    """31 bytes whose words neither repeat nor share a hash with the first
    word, the first word again, then `tail`: the first match of the chunk
    is found by lane 31 of the first window (ops/s2.py window_parse)."""
    from minio_tpu_torch.ops import s2

    while True:
        head = rng.bytes(31)
        chunk = head + head[:4] + tail
        if s2.window_parse(chunk).matches[0][0] == 31:
            return chunk


def s2_pool(rng) -> dict:
    from minio_tpu_torch.entry import seeded_text

    text = seeded_text(8 * PACKAGE + 12_345, 80)
    pool = {f"text{i}": text[i * PACKAGE:(i + 1) * PACKAGE]
            for i in range(8)}
    pool.update({"random0": rng.bytes(PACKAGE), "random1": rng.bytes(PACKAGE),
                 "zeros": bytes(PACKAGE), "tail": text[8 * PACKAGE:]})
    pool.update({f"len{n}": text[:n] for n in range(9)})
    pool.update({f"run{n}": b"a" * n for n in S2_RUNS})
    pool.update({f"period{p}": periodic_chunk(rng, p, PACKAGE)
                 for p in S2_PERIODS})
    pool["lane31"] = lane31_chunk(rng, text[:4096])
    # Text with a third of its 512-byte runs random: a block (~55 KB)
    # longer than kernel F stages, whose rest F reads from global memory.
    mixed = bytearray(text[:PACKAGE])
    for i in range(0, PACKAGE, 512):
        if rng.random() < 1 / 3:
            mixed[i:i + 512] = rng.bytes(512)
    pool["mixed"] = bytes(mixed)
    pool.update({f"short{n}": bytes(rng.choice(np.frombuffer(b"abc", np.uint8),
                                               n))
                 for n in S2_SHORT})
    return pool


def s2_plain(pool: dict) -> dict:
    """Each distinct chunk's plain answers: (block, masked CRC, frame
    type, frame body, raw bytes F gives, F's status)."""
    from minio_tpu_torch.ops import s2

    out = {}
    for name, raw in pool.items():
        data = torch.frombuffer(bytearray(raw), dtype=torch.uint8) \
            if raw else torch.empty(0, dtype=torch.uint8)
        desc = torch.tensor([[0, len(raw), 0]], dtype=torch.int64)
        blk, crc, ln = s2.compress_plain(data, desc,
                                         s2.max_compressed(len(raw)))
        block = blk.numpy().tobytes()[:int(ln[0])]
        crc = int(crc[0])
        ftype = 0 if len(block) < len(raw) else 1
        body = struct.pack("<I", crc) + (block if ftype == 0 else raw)
        fdata = torch.frombuffer(bytearray(body), dtype=torch.uint8)
        fdesc = torch.tensor([[ftype, 0, len(body), 0, len(raw)]],
                             dtype=torch.int64)
        plain, st = s2.decompress_plain(fdata, fdesc, len(raw))
        out[name] = (block, crc, ftype, body, plain.numpy().tobytes(),
                     int(st[0]))
    return out


def s2_batch_names(pool: dict, n: int) -> list[str]:
    """A batch of n chunks cycling through the pool, a 4,097-chunk batch
    ending in the tail as the object's does."""
    names = list(pool)
    batch = [names[i % len(names)] for i in range(n)]
    if n == 4097:
        batch[-1] = "tail"
    return batch


def s2_run_e(pool: dict, names: list[str]):
    """Kernel E over the chunks `names`: (desc, out, crcs, lens) on the
    host."""
    from minio_tpu_torch.ops import s2, s2_cuda

    raw = b"".join(pool[n] for n in names)
    rows, in_off, out_off = [], 0, 0
    for n in names:
        rows.append((in_off, len(pool[n]), out_off))
        in_off += len(pool[n])
        out_off += s2.max_compressed(len(pool[n]))
    desc = torch.tensor(rows, dtype=torch.int64).cuda()
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).cuda()
    out, crcs, lens = s2_cuda.compress_cuda(data, desc, out_off)
    torch.cuda.synchronize()
    return rows, out.cpu().numpy(), crcs.cpu().tolist(), lens.cpu().tolist()


def s2_run_f(bodies: list, types: list, out_lens: list):
    """Kernel F over frame bodies: (out, status) on the host, with the
    desc rows."""
    from minio_tpu_torch.ops import s2_cuda

    rows, off, out_off = [], 0, 0
    for t, b, n in zip(types, bodies, out_lens):
        rows.append((t, off, len(b), out_off, n))
        off += len(b)
        out_off += n
    data = torch.frombuffer(bytearray(b"".join(bodies)),
                            dtype=torch.uint8).cuda()
    out, status = s2_cuda.decompress_cuda(
        data, torch.tensor(rows, dtype=torch.int64).cuda(), out_off)
    torch.cuda.synchronize()
    return rows, out.cpu().numpy(), status.cpu().tolist()


def _bytes_err(a: bytes, b: bytes) -> int:
    if len(a) != len(b):
        return 256
    if a == b:
        return 0
    x = np.frombuffer(a, dtype=np.uint8).astype(np.int32)
    y = np.frombuffer(b, dtype=np.uint8).astype(np.int32)
    return int(np.abs(x - y).max())


def s2_batch_case(pool: dict, plain: dict, n: int, errs: dict) -> None:
    """Kernels E and F on a batch of n chunks of the pool against the
    plain answers: every block, CRC and length of E, every raw byte and
    status of F; the max abs differences kept in errs."""
    names = s2_batch_names(pool, n)
    rows, out, crcs, lens = s2_run_e(pool, names)
    err = 0
    for (_, _, o), name, crc, ln in zip(rows, names, crcs, lens):
        block, pcrc = plain[name][0], plain[name][1]
        err = max(err, abs(ln - len(block)), abs(crc - pcrc),
                  _bytes_err(out[o:o + ln].tobytes(), block))
    errs["s2_compress"] = max(errs["s2_compress"], err)
    log(f"s2_compress {n} chunks: max_abs_err {err}")
    frames = [plain[nm] for nm in names]
    _, fout, status = s2_run_f([f[3] for f in frames],
                               [f[2] for f in frames],
                               [len(pool[nm]) for nm in names])
    err, pos = 0, 0
    for nm, st, f in zip(names, status, frames):
        ln = len(pool[nm])
        err = max(err, abs(st - f[5]),
                  _bytes_err(fout[pos:pos + ln].tobytes(), f[4]))
        pos += ln
    errs["s2_decompress"] = max(errs["s2_decompress"], err)
    log(f"s2_decompress {n} frames: max_abs_err {err}")


def check_s2_kernels(rng, errs: dict) -> None:
    """Phase 3 of kernels E and F, exact: every block, CRC and length of
    E and every raw byte and status of F against the plain versions, at
    S2_BATCHES over s2_pool(); F on a frame with a flipped CRC byte
    (status 1) and on a truncated block (status 2), on a valid block
    longer than F stages, and on a batch of hostile frames
    (s2_run_hostile)."""
    pool = s2_pool(rng)
    t0 = time.perf_counter()
    plain = s2_plain(pool)
    log(f"s2 plain answers for {len(pool)} distinct chunks in "
        f"{time.perf_counter() - t0:.2f} s")
    errs["s2_compress"] = errs["s2_decompress"] = 0
    for n in S2_BATCHES:
        s2_batch_case(pool, plain, n, errs)
    # Tampered frames: a flipped CRC byte, a truncated block; a good frame
    # between them decodes.
    good = plain["text0"]
    bad_crc = bytearray(good[3])
    bad_crc[1] ^= 0x20
    short = plain["text1"][3][:-5]
    bodies = [bytes(bad_crc), good[3], short]
    from minio_tpu_torch.ops import s2

    desc = torch.tensor([[0, 0, len(bodies[0]), 0, PACKAGE],
                         [0, len(bodies[0]), len(bodies[1]), PACKAGE,
                          PACKAGE],
                         [0, len(bodies[0]) + len(bodies[1]),
                          len(bodies[2]), 2 * PACKAGE, PACKAGE]],
                        dtype=torch.int64)
    _, p_status = s2.decompress_plain(
        torch.frombuffer(bytearray(b"".join(bodies)), dtype=torch.uint8),
        desc, 3 * PACKAGE)
    _, fout, status = s2_run_f(bodies, [0, 0, 0], [PACKAGE] * 3)
    want = [s2.STATUS_CRC, s2.STATUS_OK, s2.STATUS_CORRUPT]
    err = max(abs(a - b) for a, b in zip(status + p_status.tolist(),
                                         want + want))
    err = max(err, _bytes_err(fout[PACKAGE:2 * PACKAGE].tobytes(), good[4]))
    errs["s2_decompress"] = max(errs["s2_decompress"], err)
    log(f"s2_decompress tampered (CRC, good, truncated): kernel {status}, "
        f"plain {p_status.tolist()}, max_abs_err {err}")
    # A valid block longer than F's staged window: the rest of its body is
    # read from global memory.
    body = long_block_body(PACKAGE)
    p_out, p_status = s2.decompress_plain(
        torch.frombuffer(bytearray(body), dtype=torch.uint8),
        torch.tensor([[0, 0, len(body), 0, PACKAGE]], dtype=torch.int64),
        PACKAGE)
    _, fout, status = s2_run_f([body], [0], [PACKAGE])
    err = max(status[0], int(p_status[0]),
              _bytes_err(fout.tobytes(), p_out.numpy().tobytes()),
              _bytes_err(fout.tobytes(), b"a" * PACKAGE))
    errs["s2_decompress"] = max(errs["s2_decompress"], err)
    log(f"s2_decompress a {len(body)} B body of 1-byte copies: status "
        f"{status}, max_abs_err {err}")
    # Malformed and valid blocks at every check of F, in one batch: random
    # tags cut, flipped and extended, copies at S2_FAR_OFFSETS, and the
    # long block cut and flipped past F's staged window.
    t0 = time.perf_counter()
    status, p_status, fout, p_out, rows = s2_run_hostile(
        rng, 200, [(body[4:], PACKAGE)])
    err = max(abs(a - b) for a, b in zip(status, p_status))
    for (_, _, _, o, n), st in zip(rows, p_status):
        if st != s2.STATUS_CORRUPT:
            err = max(err, _bytes_err(fout[o:o + n].tobytes(),
                                      p_out[o:o + n].tobytes()))
    errs["s2_decompress"] = max(errs["s2_decompress"], err)
    log(f"s2_decompress {len(rows)} hostile frames "
        f"({p_status.count(s2.STATUS_CORRUPT)} malformed): max_abs_err "
        f"{err} in {time.perf_counter() - t0:.2f} s")


def long_block_body(n: int) -> bytes:
    """A frame body (masked CRC, snappy block) of n bytes "a": a literal
    byte, then n - 1 one-byte copies at offset 1 (three bytes a tag), a
    valid block about three times the raw length."""
    from minio_tpu_torch.ops import s2

    block = (s2._varint(n) + bytes([0, ord("a")])
             + bytes([2, 1, 0]) * (n - 1))
    return struct.pack("<I", s2._masked_crc(b"a" * n)) + block


# Kind-3 copy offsets that no 64 KiB block takes; from 0x80000000 on they
# are negative as 32-bit ints. Kernel F flags each as malformed.
S2_FAR_OFFSETS = (0x10000, 0x7FFFFFFF, 0x80000000, 0xC0000000, 0xFFFF0000)
S2_BODY_STAGE = 48_640  # the bytes of a block that kernel F stages


def s2_random_tags(rng) -> tuple[bytes, int]:
    """A valid block of random tags (every kind and header form: literal
    lengths in 0-4 extra bytes, offsets in 1, 2 or 4 bytes) and its raw
    length."""
    from minio_tpu_torch.ops import s2

    tags, o = bytearray(), 0
    for _ in range(int(rng.integers(1, 12))):
        if o == 0 or rng.random() < 0.4:
            n = int(rng.integers(1, 70))
            extra = int(rng.integers(0 if n <= 60 else 1, 5))
            tags += (bytes([(n - 1) << 2]) if not extra else
                     bytes([(59 + extra) << 2])
                     + (n - 1).to_bytes(extra, "little"))
            tags += rng.bytes(n)
        else:
            kind = int(rng.integers(1, 4))
            off = int(rng.integers(1, (min(o, 2047) if kind == 1 else o) + 1))
            n = int(rng.integers(4, 12) if kind == 1 else rng.integers(1, 65))
            if kind == 1:
                tags += bytes([((off >> 8) << 5) | ((n - 4) << 2) | 1,
                               off & 0xFF])
            else:
                tags += bytes([((n - 1) << 2) | kind]) + off.to_bytes(
                    2 if kind == 2 else 4, "little")
        o += n
    return s2._varint(o) + bytes(tags), o


def s2_hostile_blocks(rng, n: int, long_blocks=()) -> list:
    """(block, raw length F is given) at every check of kernel F: copies
    at S2_FAR_OFFSETS (as the first tag and after a literal); n random
    valid blocks (s2_random_tags), each also cut, flipped or extended, and
    with a last copy at the output's edge (offset o) and past it (o + 1);
    and each of `long_blocks` (longer than F stages) whole, cut and
    flipped past the staged window, and ending in a far copy."""
    from minio_tpu_torch.ops import s2

    cases = []
    for off in S2_FAR_OFFSETS:
        far = bytes([(7 << 2) | 3]) + off.to_bytes(4, "little")
        cases.append((s2._varint(8) + far, 8))
        cases.append((s2._varint(24) + bytes([15 << 2]) + rng.bytes(16)
                      + far, 24))
    for _ in range(n):
        block, want = s2_random_tags(rng)
        cases.append((block, want))
        cases.append((block[:int(rng.integers(len(block) + 1))], want))
        bad = bytearray(block + rng.bytes(int(rng.integers(3))))
        bad[int(rng.integers(len(bad)))] ^= 1 << int(rng.integers(8))
        cases.append((bytes(bad),
                      int(rng.choice([want, want + 1, max(0, want - 1)]))))
        tags = block[len(s2._varint(want)):]
        for off in (want, want + 1):
            cases.append((s2._varint(want + 4) + tags + bytes([(3 << 2) | 2])
                          + off.to_bytes(2, "little"), want + 4))
    for block, want in long_blocks:
        cases.append((block, want))
        for _ in range(2):
            cases.append((block[:int(rng.integers(S2_BODY_STAGE,
                                                  len(block)))], want))
            bad = bytearray(block)
            bad[int(rng.integers(S2_BODY_STAGE, len(bad)))] ^= \
                1 << int(rng.integers(8))
            cases.append((bytes(bad), want))
        cases.append((block + bytes([(7 << 2) | 3])
                      + S2_FAR_OFFSETS[2].to_bytes(4, "little"), want))
    return cases


def s2_run_hostile(rng, n: int, long_blocks=()):
    """Kernel F and decompress_plain over s2_hostile_blocks as the frames
    of one batch, each with the masked CRC of its decode (one in eight
    flipped; 0 where it does not decode): (F's statuses, the plain
    statuses, F's output, the plain output, the desc rows)."""
    from minio_tpu_torch.ops import s2

    bodies, out_lens = [], []
    for block, cap in s2_hostile_blocks(rng, n, long_blocks):
        try:
            crc = s2._masked_crc(s2._decompress_block_py(block, cap))
        except ValueError:
            crc = 0
        if rng.random() < 1 / 8:
            crc ^= 1 << int(rng.integers(32))
        bodies.append(struct.pack("<I", crc) + block)
        out_lens.append(cap)
    rows, fout, status = s2_run_f(bodies, [0] * len(bodies), out_lens)
    p_out, p_status = s2.decompress_plain(
        torch.frombuffer(bytearray(b"".join(bodies)), dtype=torch.uint8),
        torch.tensor(rows, dtype=torch.int64), sum(out_lens))
    return (status, p_status.tolist(), fout, p_out.numpy(), rows)


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
    from minio_tpu_torch.ops import (aes_gcm_cuda, highwayhash_torch,
                                     rs_cuda, s2_cuda)

    s2_cuda.COMPRESS_LAUNCHES.reset()
    s2_cuda.DECOMPRESS_LAUNCHES.reset()
    s2_cuda.COMPRESS_LAUNCHES_BY_SHAPE.reset()
    s2_cuda.DECOMPRESS_LAUNCHES_BY_SHAPE.reset()
    rs_cuda.LAUNCHES.reset()
    rs_cuda.LAUNCHES_BY_SHAPE.reset()
    highwayhash_torch.LAUNCHES.reset()
    aes_gcm_cuda.SEAL_LAUNCHES.reset()
    aes_gcm_cuda.OPEN_LAUNCHES.reset()
    aes_gcm_cuda.SEAL_LAUNCHES_BY_SHAPE.reset()
    aes_gcm_cuda.OPEN_LAUNCHES_BY_SHAPE.reset()
    device_engine.reset_stats()


def read_counts() -> dict:
    from minio_tpu_torch.ops import (aes_gcm_cuda, highwayhash_torch,
                                     rs_cuda, s2_cuda)

    return {"gf_apply": rs_cuda.LAUNCHES.value,
            "highwayhash256": highwayhash_torch.LAUNCHES.value,
            "aes_gcm_seal": aes_gcm_cuda.SEAL_LAUNCHES.value,
            "aes_gcm_open": aes_gcm_cuda.OPEN_LAUNCHES.value,
            "s2_compress": s2_cuda.COMPRESS_LAUNCHES.value,
            "s2_decompress": s2_cuda.DECOMPRESS_LAUNCHES.value}


def read_s2_shape_counts() -> dict:
    """Kernels E's and F's launches by chunk count."""
    from minio_tpu_torch.ops import s2_cuda

    return {"s2_compress": s2_cuda.COMPRESS_LAUNCHES_BY_SHAPE.snapshot(),
            "s2_decompress":
                s2_cuda.DECOMPRESS_LAUNCHES_BY_SHAPE.snapshot()}


def read_shape_counts() -> dict:
    """Kernel A's launches by shape, "{R}x{K}", counted by its wrapper."""
    from minio_tpu_torch.ops import rs_cuda

    return rs_cuda.LAUNCHES_BY_SHAPE.snapshot()


def read_aes_shape_counts() -> dict:
    """Kernels C's and D's launches by package count, counted by their
    wrappers."""
    from minio_tpu_torch.ops import aes_gcm_cuda

    return {"aes_gcm_seal": aes_gcm_cuda.SEAL_LAUNCHES_BY_SHAPE.snapshot(),
            "aes_gcm_open": aes_gcm_cuda.OPEN_LAUNCHES_BY_SHAPE.snapshot()}


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
    launches = dict.fromkeys(read_counts(), 0)
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
    log(f"4j the first scan cycle's sampled heals: "
        f"{res['scan_sampled_heals']}")
    log(f"4j kernel A launches by (rows out)x(rows in): {tally}")
    line = {"object_size": res["size"], "k": K, "m": M,
            "outage_drive": res["outage_drive"],
            "wiped_drive": res["wiped_drive"],
            "offline_drives": res["offline_drives"],
            "objects": res["objects"], "codecs": res["codecs"],
            "mrf_queued": res["mrf_queued"], "seconds": res["seconds"],
            "launches": per_phase, "gf_apply_by_shape": tally,
            "sweep": res["sweep"], "usage": res["usage"],
            "scan_sampled_heals": res["scan_sampled_heals"],
            "checks": res["checks"]}
    return line, launches, res["system_objects"]


# Phase 4k's steps of each mode, and the kernels each must launch: "C"
# (seal), "D" (open), "AB" (encode or rebuild, and hash); "heal" must
# launch A and B and never C or D. HEAD, and a GET whose SSE-C key's MD5
# is not the object's (refused before any unseal, as in minio_tpu),
# launch none of them.
SSE_STEPS = {"put": ("C", "AB"), "get": ("D",), "range_get": ("D",),
             "head": (), "degraded_get": ("D", "AB"), "heal": ("AB",),
             "get_after_heal": ("D",)}
SSE_TAIL_STEPS = {"copy_ssec_to_sses3": ("C", "D", "AB"),
                  "get_copy": ("D",), "wrong_key_get": ()}


def run_sse() -> tuple[dict, dict]:
    """Phase 4k: entry.s3_sse, server-side encryption over HTTP."""
    from minio_tpu_torch.entry import s3_sse

    data_root = ROOT / ".smoke_data"
    data_root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=data_root)
    try:
        reset_counts()
        res = s3_sse(tmp, OBJECT_SIZE, device="cuda", seed=50)
        launches = read_counts()
        by_shape = read_aes_shape_counts()
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    failed = [k for k, ok in res["checks"].items() if ok is not True]
    if failed:
        raise AssertionError(f"SSE checks failed: {failed}")
    steps = {f"{m}:{st}": want for m in res["modes"]
             for st, want in SSE_STEPS.items()}
    steps.update(SSE_TAIL_STEPS)
    per_step, gbps = {}, {}
    for name, want in steps.items():
        c = res["counters"][name]
        n = {"A": c["kernel_gf_launches"], "B": c["kernel_hash_launches"],
             "C": c["kernel_seal_launches"], "D": c["kernel_open_launches"]}
        per_step[name] = dict(n, hedged_reads=c["hedged_reads_total"])
        need = {k for w in want for k in w}
        ok = all(n[k] > 0 for k in need)
        if name.endswith(":heal"):
            ok = ok and n["C"] == n["D"] == 0
        if not want:
            ok = not any(n.values())
        if not ok or c["hedged_reads_total"]:
            raise AssertionError(f"SSE {name}: launches {n}, hedged reads "
                                 f"{c['hedged_reads_total']}, want "
                                 f"{''.join(want) or 'none'}")
        sec = res["seconds"][name]
        moved = (res["range"][1] if name.endswith("range_get")
                 else 0 if name.endswith(("head", "wrong_key_get"))
                 else res["size"])
        gbps[name] = moved / sec / 1e9
        log(f"4k {name}: {sec:.4f} s, {gbps[name]:.4f} GB/s of object, "
            f"launches A {n['A']} B {n['B']} C {n['C']} D {n['D']}")
    for name, peak in res["rss_peak_bytes"].items():
        log(f"4k {name}: peak resident set growth {peak / 2**20:.1f} MiB")
    log(f"4k launches of C and D by package count: {by_shape}")
    card = card_line()
    log(f"4k on {card}")
    line = {"card": card,
            "object_size": res["size"], "stored_size": res["stored_size"],
            "packages": res["packages"], "k": K, "m": M,
            "wiped_drives": res["wiped_drives"], "range": res["range"],
            "seconds": res["seconds"], "gbps": gbps, "launches": per_step,
            "aes_launches_by_packages": by_shape,
            "rss_peak_bytes": res["rss_peak_bytes"],
            "checks": res["checks"]}
    return line, launches


# Phase 4l's steps, their sub-steps, and the sub-steps that must launch
# kernel A (a degraded GET or a heal).
ADMISSION_STEPS = {
    "a": ("fair_puts", "fair_gets"),
    "b": ("queue_full_puts", "saturated_get", "tenant_puts"),
    "c": ("healthy_put", "get_before_latch", "get_after_latch",
          "put_before_latch", "put_after_latch"),
    "d": ("heal_under_backlog", "heal_no_backlog")}
ADMISSION_NEED_A = ("get_before_latch", "get_after_latch",
                    "heal_under_backlog")


def run_admission() -> tuple[dict, dict]:
    """Phase 4l: entry.admission_drive_health, the admission governors
    and the drive health wrapper of a Server over HTTP."""
    from minio_tpu_torch.entry import admission_drive_health

    data_root = ROOT / ".smoke_data"
    data_root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=data_root)
    try:
        reset_counts()
        res = admission_drive_health(tmp, ADMISSION_SIZE, OBJECT_SIZE,
                                     device="cuda", seed=60)
        launches = read_counts()
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    failed = [k for k, ok in res["checks"].items() if ok is not True]
    if failed:
        raise AssertionError(f"admission checks failed: {failed}")
    card = card_line()
    per_sub, per_step = {}, {}
    for step, subs in ADMISSION_STEPS.items():
        tot = {"A": 0, "B": 0, "C": 0, "D": 0, "seconds": 0.0}
        for sub in subs:
            c = res["counters"][sub]
            n = {"A": c["kernel_gf_launches"], "B": c["kernel_hash_launches"],
                 "C": c["kernel_seal_launches"],
                 "D": c["kernel_open_launches"]}
            per_sub[sub] = dict(n, seconds=res["seconds"][sub])
            if n["C"] or n["D"] or (sub in ADMISSION_NEED_A and n["A"] <= 0):
                raise AssertionError(f"4l {sub}: launches {n}")
            for key in n:
                tot[key] += n[key]
            tot["seconds"] += res["seconds"][sub]
            log(f"4l {step} {sub}: {res['seconds'][sub]:.4f} s, launches "
                f"A {n['A']} B {n['B']} C {n['C']} D {n['D']} ({card})")
        if tot["B"] <= 0:
            raise AssertionError(f"4l step {step}: kernel B never launched")
        per_step[step] = tot
    hung = res["hung_drive"]
    log(f"4l grant order {res['fairness']['grant_order']}, quiet wait "
        f"{res['fairness']['quiet_wait_s']:.4f} s ({card})")
    log(f"4l refusals {res['overload']['queue_full']['refusal_seconds']} s, "
        f"fail fast {hung['fail_fast_s']:.6f} s, readmitted after "
        f"{hung['readmit_s']} s ({card})")
    log(f"4l stalled drive health: {hung['health']}")
    log(f"4l pacer: after c {hung['pacer_after_c']}, under backlog "
        f"{hung['pacer_under_backlog']}, no backlog "
        f"{hung['pacer_no_backlog']}")
    line = {"card": card, "size": res["size"],
            "hung_size": res["hung_size"], "k": K, "m": M,
            "stalled_drive": res["stalled_drive"], "robust": res["robust"],
            "seconds": res["seconds"], "steps": per_step,
            "launches": per_sub, "fairness": res["fairness"],
            "overload": res["overload"],
            "hung_drive": {k: hung[k] for k in (
                "health", "fail_fast_s", "readmit_s", "latch_pokes_get",
                "latch_pokes_put", "backlog", "heal_state",
                "pacer_after_c", "pacer_under_backlog", "pacer_no_backlog",
                "governor", "stalled_ops")},
            "disk_health": res["disk_health"], "checks": res["checks"]}
    return line, launches


# Phase 4m's steps and the kernels each must launch (None: unchecked; a
# new bucket's metadata is a small object, which the set may encode).
OBS_STEPS = {"make_bucket": None, "put": "AB", "get": "B",
             "degraded_get": "AB", "heal": "AB", "sse_put": "ABC",
             "sse_get": "BD"}
# The span plane's cost: phase 4e armed, then disarmed, with 64 small
# objects, not 256, one run of each mode, to keep the smoke inside its
# time (4k's pair is cut: a second server phase adds time, not a mode).
PLANE_RUNS = (("on", None), ("off", "0"))
PLANE_SMALL_COUNT = 64


def plane_call(d: str) -> dict:
    """Phase 4m's cost run: 4e's entry point as its phase calls it, at
    PLANE_SMALL_COUNT small objects."""
    from minio_tpu_torch.entry import s3_put_get_heal

    return s3_put_get_heal(
        d, OBJECT_SIZE, device="cuda", part_size=MP_PART, parts=MP_PARTS,
        last_part=MP_LAST, small_count=PLANE_SMALL_COUNT,
        small_sizes=SMALL_SIZES, page=100, concurrent=4, seed=4)


def run_observability() -> tuple[dict, dict]:
    """Phase 4m: entry.observability, the health probes, the metrics
    scrapes, the request spans and the byte-flow ledger of a Server over
    HTTP."""
    from minio_tpu_torch.entry import observability

    data_root = ROOT / ".smoke_data"
    data_root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=data_root)
    try:
        reset_counts()
        res = observability(tmp, OBJECT_SIZE, device="cuda", seed=70)
        launches = read_counts()
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    failed = [k for k, ok in res["checks"].items() if ok is not True]
    if failed:
        raise AssertionError(f"observability checks failed: {failed}")
    card = card_line()
    per_step = {}
    for name, want in OBS_STEPS.items():
        c = res["counters"][name]
        n = {"A": c["kernel_gf_launches"], "B": c["kernel_hash_launches"],
             "C": c["kernel_seal_launches"],
             "D": c["kernel_open_launches"]}
        per_step[name] = dict(n, seconds=res["seconds"][name],
                              hedged_reads=c["hedged_reads_total"])
        if c["hedged_reads_total"] or (
                want is not None
                and {k for k, v in n.items() if v > 0} != set(want)):
            raise AssertionError(f"4m {name}: launches {n}, hedged reads "
                                 f"{c['hedged_reads_total']}, want "
                                 f"{want}")
        log(f"4m step {name}: {res['seconds'][name]:.4f} s, launches "
            f"A {n['A']} B {n['B']} C {n['C']} D {n['D']} ({card})")
    for name, trees in res["trees"].items():
        for t in trees:
            kinds = ", ".join(f"{k} {v:.4f}" for k, v in sorted(
                t["seconds_by_kind"].items(), key=lambda kv: -kv[1]))
            log(f"4m tree {name} {t['api']}: {t['duration_ms']} ms, "
                f"{t['spans']} spans, cut short {t['cut_short']}; seconds "
                f"by kind: {kinds}; engine deltas {t['stats']}")
    for name, led in res["ledger"].items():
        log(f"4m ledger {name}: bytes {led['bytes']}, logical "
            f"{led['logical']}")
    part, meta = res["drive_bytes"]["part"], res["drive_bytes"]["meta"]
    log(f"4m drives hold part files {sum(part.values())} B and xl.meta "
        f"{sum(meta.values())} B of the plain object; ledger checks "
        f"{sorted(k for k in res['checks'] if k.startswith('ledger:'))}")
    log(f"4m scrape: {len(res['scrape']['families'])} series families, "
        f"outside the catalog {res['scrape']['outside_catalog']}: "
        f"{res['scrape']['families']}")
    log(f"4m health codes: {res['health']}")
    line = {"card": card, "size": res["size"], "k": K, "m": M,
            "lost": res["lost"], "fifth": res["fifth"],
            "steps": per_step, "trees": res["trees"],
            "ledger": res["ledger"], "drive_bytes": res["drive_bytes"],
            "health": res["health"], "heal": res["heal"],
            "scrape": res["scrape"],
            "admin_slow_requests": res["admin_slow_requests"],
            "checks": res["checks"]}
    return line, launches


def plane_cost() -> dict:
    """Phase 4m's cost of the span plane: phase 4e (plane_call) with the
    plane armed (MTPU_TRACE unset) and disarmed (MTPU_TRACE=0), on then
    off (PLANE_RUNS); each call's seconds, whole. Each run starts with a
    fresh heal pacer, as phase 4l leaves it: the pacer's latency window
    is the process's, and a window an earlier run left slow would make
    every heal of the next wait its deadline."""
    from minio_tpu_torch.background import healpace
    from minio_tpu_torch.entry import env_vars

    card = card_line()
    runs = []
    for mode, value in PLANE_RUNS:
        data_root = ROOT / ".smoke_data"
        data_root.mkdir(exist_ok=True)
        tmp = tempfile.mkdtemp(dir=data_root)
        healpace.reset()
        try:
            with env_vars(MTPU_TRACE=value):
                t0 = time.perf_counter()
                res = plane_call(tmp)
                sec = time.perf_counter() - t0
        finally:
            shutil.rmtree(data_root, ignore_errors=True)
        failed = [k for k, ok in res["checks"].items() if ok is not True]
        if failed:
            raise AssertionError(f"4m plane {mode} 4e: {failed}")
        runs.append({"phase": "4e", "plane": mode, "seconds": sec})
        log(f"4m plane {mode} 4e: {sec:.3f} s ({card})")
    return {"card": card, "runs": runs}


# Phase 4n's steps: the kernels each must launch and those it must not
# (A..F). `restart` builds a Server, whose warm-up runs every kernel: only
# the config's load (D) is checked there.
CFG_STEPS = {
    "settings": ("C", ""), "put": ("EAB", "DF"), "get": ("BF", "ACDE"),
    "range_get": ("BF", "ACDE"), "degraded_get": ("ABF", "CDE"),
    "heal": ("AB", "CDEF"), "sse_put": ("EABC", "DF"),
    "sse_get": ("BDF", "ACE"), "random_put": ("EAB", "CDF"),
    "rrs_put": ("AB", "CDEF"), "restart": ("D", ""),
    "get_after_restart": ("BF", "ACDE"), "slowdown": ("", "ABCDEF")}


def run_config_compression() -> tuple[dict, dict]:
    """Phase 4n: entry.config_compression, the config subsystem and
    compression of a Server over HTTP."""
    from minio_tpu_torch.entry import config_compression

    data_root = ROOT / ".smoke_data"
    data_root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=data_root)
    try:
        reset_counts()
        res = config_compression(tmp, OBJECT_SIZE, device="cuda", seed=80)
        launches = read_counts()
        by_shape = read_s2_shape_counts()
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    failed = [k for k, ok in res["checks"].items() if ok is not True]
    if failed:
        raise AssertionError(f"config/compression checks failed: {failed}")
    card = card_line()
    per_step = {}
    for name, (need, forbid) in CFG_STEPS.items():
        c = res["counters"][name]
        n = {"A": c["kernel_gf_launches"], "B": c["kernel_hash_launches"],
             "C": c["kernel_seal_launches"], "D": c["kernel_open_launches"],
             "E": c["kernel_compress_launches"],
             "F": c["kernel_decompress_launches"]}
        per_step[name] = dict(n, seconds=res["seconds"][name],
                              gf_by_shape=res["gf_by_shape"][name])
        ok = (all(n[k] > 0 for k in need)
              and not any(n[k] for k in forbid))
        if name == "random_put":
            ok = ok and n["E"] == 1  # the probe alone
        if name == "rrs_put":
            ok = ok and res["gf_by_shape"][name].get("2x14", 0) > 0
        if not ok:
            raise AssertionError(f"4n {name}: launches {n}, A by shape "
                                 f"{res['gf_by_shape'][name]}, want "
                                 f"{need or 'none'}, never {forbid}")
        log(f"4n {name}: {res['seconds'][name]:.4f} s, launches A {n['A']} "
            f"B {n['B']} C {n['C']} D {n['D']} E {n['E']} F {n['F']} "
            f"({card})")
    log(f"4n stored {res['stored_size']} B of {res['size']} B (ratio "
        f"{res['ratio']:.4f}), SSE {res['sse_stored_size']} B; RRS "
        f"{res['rrs_geometry']}; slowdown after "
        f"{res['slowdown_wait_s']:.3f} s; E and F by chunk count {by_shape}")
    line = {"card": card, "size": res["size"], "k": K, "m": M,
            "lost": res["lost"], "range": res["range"],
            "stored_size": res["stored_size"], "ratio": res["ratio"],
            "sse_stored_size": res["sse_stored_size"],
            "rrs_geometry": res["rrs_geometry"], "heal": res["heal"],
            "slowdown_wait_s": res["slowdown_wait_s"],
            "seconds": res["seconds"], "launches": per_step,
            "s2_launches_by_chunks": by_shape, "checks": res["checks"]}
    return line, launches


LQL_STEPS = {
    "worm_put_v1": ("AB", "CDEF"), "worm_put_v2": ("AB", "CDEF"),
    "worm_delete_v1": ("", "ABCDEF"), "worm_delete_objects": ("", "ABCDEF"),
    "worm_delete_marker": ("", "ABCDEF"), "worm_tighten": ("", "ABCDEF"),
    "worm_shorten": ("", "ABCDEF"), "worm_degraded_get": ("AB", "CDEF"),
    "worm_heal": ("AB", "CDEF"), "worm_multipart": ("AB", "CDEF"),
    "gov_put": ("AB", "CDEF"), "gov_delete": ("", "ABCDEF"),
    "hold_put": ("AB", "CDEF"), "hold_delete": ("", "ABCDEF"),
    "quota_set": ("", "CDEF"), "quota_put": ("AB", "CDEF"),
    "quota_refused_put": ("", "ABCDEF"), "quota_refused_part": ("", "ABCDEF"),
    "quota_scan": ("", "CDEF"), "quota_clear": ("", "CDEF"),
    "quota_put_after_clear": ("AB", "CDEF"), "ilm_setup": ("AB", "CDEF"),
    "ilm_sweep": ("", "ABCDEF"), "ilm_scan": ("", "CDEF")}


def run_lock_quota_lifecycle() -> tuple[dict, dict, dict]:
    """Phase 4o: entry.s3_lock_quota_lifecycle, object lock, the hard
    quota and lifecycle expiry of a Server over HTTP."""
    from minio_tpu_torch.entry import s3_lock_quota_lifecycle

    data_root = ROOT / ".smoke_data"
    data_root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=data_root)
    try:
        reset_counts()
        res = s3_lock_quota_lifecycle(tmp, OBJECT_SIZE, device="cuda",
                                      small_size=LQL_SMALL,
                                      refused_size=LQL_REFUSED,
                                      quota=LQL_QUOTA, seed=90)
        launches = read_counts()
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    failed = [k for k, ok in res["checks"].items() if ok is not True]
    if failed:
        raise AssertionError(f"lock/quota/lifecycle checks failed: {failed}")
    card = card_line()
    per_step = {}
    for name, (need, forbid) in LQL_STEPS.items():
        c = res["counters"][name]
        n = {"A": c["kernel_gf_launches"], "B": c["kernel_hash_launches"],
             "C": c["kernel_seal_launches"], "D": c["kernel_open_launches"],
             "E": c["kernel_compress_launches"],
             "F": c["kernel_decompress_launches"]}
        per_step[name] = dict(n, seconds=res["seconds"][name],
                              gf_by_shape=res["gf_by_shape"][name])
        if (not all(n[k] > 0 for k in need)
                or any(n[k] for k in forbid)):
            raise AssertionError(f"4o {name}: launches {n}, A by shape "
                                 f"{res['gf_by_shape'][name]}, want "
                                 f"{need or 'none'}, never {forbid}")
        log(f"4o {name}: {res['seconds'][name]:.4f} s, launches A {n['A']} "
            f"B {n['B']} C {n['C']} D {n['D']} E {n['E']} F {n['F']} "
            f"({card})")
    log(f"4o total {sum(res['seconds'].values()):.3f} s in its steps; "
        f"healed drives by version {res['worm_healed']}; quota usage "
        f"{res['quota_usage']}; ilm_expired_total "
        f"{res['ilm_expired_total']}")
    line = {"card": card, "size": res["size"], "small_size": LQL_SMALL,
            "refused_size": LQL_REFUSED, "quota": LQL_QUOTA, "k": K,
            "m": M, "lost": res["lost"], "worm_healed": res["worm_healed"],
            "quota_usage": res["quota_usage"],
            "ilm_expired_total": res["ilm_expired_total"],
            "seconds": res["seconds"], "launches": per_step,
            "checks": res["checks"]}
    return line, launches, res["system_objects"]


# Phase 4p's steps: the kernels each must launch (on either server) and
# those it must not. A in the transition and the degraded GET is the cold
# server's (the hot one only reads); B in the tier GETs is the cold
# server's, B in the restored GET the hot one's.
TIER_STEPS = {
    "tier_settings": ("C", ""), "tier_add": ("", "CDEF"),
    "tier_put_plain": ("AB", "CDEF"), "tier_put_sse": ("ABC", "DEF"),
    "tier_put_text": ("ABCE", "DF"), "tier_lifecycle": ("", "CDEF"),
    "tier_transition": ("AB", "CDEF"), "tier_get": ("BDF", "ACE"),
    "tier_range_get": ("BDF", "ACE"), "tier_degraded_get": ("AB", "CDEF"),
    "tier_cold_heal": ("AB", "CDEF"), "tier_restore": ("AB", "CDEF"),
    "tier_restored_get": ("B", "ACDEF"),
    "tier_restore_expiry": ("", "ABCDEF"),
    "tier_expired_get": ("B", "ACDEF"), "tier_heal": ("", "ABCDEF"),
    "tier_get_after_heal": ("BDF", "ACE"),
    "tier_remove_refused": ("", "ABCDEF")}


def run_tiering() -> tuple[dict, dict, dict]:
    """Phase 4p: entry.s3_tiering, a 12+4 server tiered to a second 12+4
    server on the card, over HTTP. Returns its line, its launches by
    kernel, and what phase 3c checks (the entry's result and C/D/E/F's
    launches by package and chunk count)."""
    from minio_tpu_torch.entry import s3_tiering

    data_root = ROOT / ".smoke_data"
    data_root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=data_root)
    try:
        reset_counts()
        res = s3_tiering(tmp, OBJECT_SIZE, device="cuda",
                         text_size=TIER_TEXT_SIZE, seed=100)
        launches = read_counts()
        aes_counts = read_aes_shape_counts()
        s2_counts = read_s2_shape_counts()
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    failed = [k for k, ok in res["checks"].items() if ok is not True]
    if failed:
        raise AssertionError(f"tiering checks failed: {failed}")
    card = card_line()
    per_step = {}
    for name, (need, forbid) in TIER_STEPS.items():
        c = res["counters"][name]
        n = {"A": c["kernel_gf_launches"], "B": c["kernel_hash_launches"],
             "C": c["kernel_seal_launches"], "D": c["kernel_open_launches"],
             "E": c["kernel_compress_launches"],
             "F": c["kernel_decompress_launches"]}
        parts = res["tier_parts"].get(name, {})
        per_step[name] = dict(n, seconds=res["seconds"][name],
                              gf_by_shape=res["gf_by_shape"][name],
                              tier_parts=parts)
        if (not all(n[k] > 0 for k in need)
                or any(n[k] for k in forbid)):
            raise AssertionError(f"4p {name}: launches {n}, A by shape "
                                 f"{res['gf_by_shape'][name]}, want "
                                 f"{need or 'none'}, never {forbid}")
        log(f"4p {name}: {res['seconds'][name]:.4f} s, launches A {n['A']} "
            f"B {n['B']} C {n['C']} D {n['D']} E {n['E']} F {n['F']}, A by "
            f"shape {res['gf_by_shape'][name]}, tier parts "
            f"{ {k: round(v, 4) for k, v in parts.items()} } ({card})")
    log(f"4p total {sum(res['seconds'].values()):.3f} s in its steps; "
        f"stored sizes {res['stored_sizes']}; cold reconstructions "
        f"{res['cold_reconstructions']}; heal {res['heal']}; C/D by "
        f"packages {aes_counts}; E/F by chunks {s2_counts}")
    line = {"card": card, "size": res["size"], "text_size": TIER_TEXT_SIZE,
            "k": K, "m": M, "lost": res["lost"],
            "range_size": res["range_size"],
            "stored_sizes": res["stored_sizes"],
            "remote_keys": res["remote_keys"],
            "cold_reconstructions": res["cold_reconstructions"],
            "ilm_transitioned_total": res["ilm_transitioned_total"],
            "ilm_restored_total": res["ilm_restored_total"],
            "heal": res["heal"], "seconds": res["seconds"],
            "launches": per_step, "aes_launches_by_packages": aes_counts,
            "s2_launches_by_chunks": s2_counts, "checks": res["checks"]}
    return line, launches, {"res": res, "aes": aes_counts, "s2": s2_counts}


# Phase 4q's steps: the kernels each must launch and those it must not.
# An IAM write is a .minio.sys PUT (A, B); an STS call, a refusal and a
# listing of users launch nothing. `restart` builds a Server, whose
# warm-up runs every kernel: only the degraded IAM load's A is checked
# there, and `iam_reload` reads the degraded blobs again alone.
IDENTITY_STEPS = {
    "idp_add_policy": ("AB", "CDEF"), "idp_add_user": ("AB", "CDEF"),
    "idp_map": ("AB", "CDEF"), "idp_list_users": ("", "ABCDEF"),
    "alice_put": ("AB", "CDEF"), "alice_get": ("B", "ACDEF"),
    "alice_put_denied": ("", "ABCDEF"), "assume_role": ("", "ABCDEF"),
    "sts_get": ("B", "ACDEF"), "sts_put_denied": ("", "ABCDEF"),
    "sts_get_no_token": ("", "ABCDEF"),
    "web_identity_hs256": ("", "ABCDEF"),
    "web_identity_rs256": ("", "ABCDEF"), "web_sse_put": ("ABC", "DEF"),
    "web_sse_get": ("BD", "ACEF"), "ldap_assume": ("", "ABCDEF"),
    "ldap_wrong_password": ("", "ABCDEF"),
    "ldap_degraded_get": ("AB", "CDEF"), "service_account": ("AB", "CDEF"),
    "sa_range_get": ("AB", "CDEF"), "sa_put_denied": ("", "ABCDEF"),
    "post_201": ("AB", "CDEF"), "post_204": ("AB", "CDEF"),
    "post_get": ("B", "ACDEF"), "post_refused": ("", "ABCDEF"),
    "restart": ("A", ""), "iam_reload": ("AB", "CDEF"),
    "after_restart": ("", "ABCDEF"), "heal_bucket": ("AB", "CDEF"),
    "heal_iam": ("AB", "CDEF")}


def run_identity() -> tuple[dict, dict, dict]:
    """Phase 4q: entry.s3_identity, IAM users, policies, service
    accounts, STS and POST policy uploads on a Server over HTTP. Returns
    its line, its launches by kernel, and what phase 3d checks (the
    entry's result and C/D's launches by package count)."""
    from minio_tpu_torch.entry import s3_identity

    data_root = ROOT / ".smoke_data"
    data_root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=data_root)
    try:
        reset_counts()
        res = s3_identity(tmp, OBJECT_SIZE, device="cuda",
                          post_size=IDP_POST_SIZE, seed=110)
        launches = read_counts()
        aes_counts = read_aes_shape_counts()
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    failed = [k for k, ok in res["checks"].items() if ok is not True]
    if failed:
        raise AssertionError(f"identity checks failed: {failed}")
    card = card_line()
    per_step = {}
    for name, (need, forbid) in IDENTITY_STEPS.items():
        c = res["counters"][name]
        n = {"A": c["kernel_gf_launches"], "B": c["kernel_hash_launches"],
             "C": c["kernel_seal_launches"], "D": c["kernel_open_launches"],
             "E": c["kernel_compress_launches"],
             "F": c["kernel_decompress_launches"]}
        per_step[name] = dict(n, seconds=res["seconds"][name],
                              gf_by_shape=res["gf_by_shape"][name])
        if (not all(n[k] > 0 for k in need)
                or any(n[k] for k in forbid)):
            raise AssertionError(f"4q {name}: launches {n}, A by shape "
                                 f"{res['gf_by_shape'][name]}, want "
                                 f"{need or 'none'}, never {forbid}")
        log(f"4q {name}: {res['seconds'][name]:.4f} s, launches A {n['A']} "
            f"B {n['B']} C {n['C']} D {n['D']} E {n['E']} F {n['F']}, A by "
            f"shape {res['gf_by_shape'][name]} ({card})")
    log(f"4q total {sum(res['seconds'].values()):.3f} s in its steps; IAM "
        f"blobs {res['iam_blobs']}; their reconstructions "
        f"{res['iam_reconstructions']}; the object's "
        f"{res['object_reconstructions']}; C/D by packages {aes_counts}")
    line = {"card": card, "size": res["size"], "post_size": IDP_POST_SIZE,
            "k": K, "m": M, "lost": res["lost"],
            "range_size": res["range_size"], "iam_blobs": res["iam_blobs"],
            "iam_reconstructions": res["iam_reconstructions"],
            "object_reconstructions": res["object_reconstructions"],
            "seconds": res["seconds"], "launches": per_step,
            "aes_launches_by_packages": aes_counts, "checks": res["checks"]}
    return line, launches, {"res": res, "aes": aes_counts}


def check_identity_kernels(rng, errs: dict, res: dict,
                           aes_counts: dict) -> None:
    """Phase 3d, after phase 4q: the shapes 4q gave the kernels that are
    known only after its run, exact. Kernel A's reconstructions of the
    object in bucket idp (which shards drives 0, 5, 12 and 15 hold
    follows from its key) at B = 1 and 8 and both of its shard lengths,
    and of each IAM blob at its own shard length (the degraded load and
    the heal), under each codec (reconstruct_errs); kernels A and B at
    the shard lengths of every .minio.sys
    object the servers wrote (check_system_object_kernels); C and D at
    each package count 4q launched them with and phase 3 did not."""
    for unavailable, targets in res["object_reconstructions"]:
        reconstruct_errs(rng, errs, unavailable, targets, [res["size"]],
                         (1, BATCH), "4q object")
    for unavailable, targets, size in res["iam_reconstructions"]:
        reconstruct_errs(rng, errs, unavailable, targets, [size], (1,),
                         f"4q IAM blob of {size} B")
    check_system_object_kernels(rng, errs, res["system_objects"])
    key = rng.bytes(32)
    counts = {int(p) for name in ("aes_gcm_seal", "aes_gcm_open")
              for p in aes_counts[name]} - aes_phase3_counts()
    for p in sorted(counts):
        lengths = [PACKAGE] * (p - 1) + [12_345]
        aads = [struct.pack("<Q", i) for i in range(p)]
        aes_case(key, aes_batch(rng, lengths, aads), f"4q batch {p}", errs)
    log(f"4q's own counts: C/D at {sorted(counts)} packages (the rest "
        f"phase 3 covers)")
    bad = {k: v for k, v in errs.items() if v != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"at 4q's shapes: {bad}")


def time_s2_kernels(rng, launches: dict, errs: dict) -> list[dict]:
    """Phase 5 for kernels E and F: CUDA events over calls at 1, 128 (a
    launch of the port's batch) and 4,097 chunks (the whole 4n object) of
    phase 4n's text and at 128 chunks of random bytes and of zeros (the
    longest and the shortest chain of windows), the plain versions' times
    at 1 and 128 chunks of text, and the byte bound: the bytes read once
    and written once over HBM_BYTES_PER_S (no operation count bounds a
    sequential match loop lower). `launches` holds each kernel's launches
    by main path, and 4n's by chunk count under "s2_by_chunks"."""
    from minio_tpu_torch.entry import seeded_text
    from minio_tpu_torch.ops import s2, s2_cuda
    from minio_tpu_torch.utils.timing import time_calls

    text = seeded_text(4096 * PACKAGE + 12_345, 80)
    by_chunks = launches["s2_by_chunks"]
    shapes = {"s2_compress": [], "s2_decompress": []}
    for kind, n in (("text", 1), ("text", 128), ("text", 4097),
                    ("random", 128), ("zeros", 128)):
        sizes = [PACKAGE] * min(n, 4096) + ([12_345] if n == 4097 else [])
        raw = {"text": lambda m: text[:m], "random": rng.bytes,
               "zeros": bytes}[kind](sum(sizes))
        rows, in_off, out_off = [], 0, 0
        for sz in sizes:
            rows.append((in_off, sz, out_off))
            in_off += sz
            out_off += s2.max_compressed(sz)
        desc = torch.tensor(rows, dtype=torch.int64).cuda()
        data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).cuda()
        out, crcs, lens = s2_cuda.compress_cuda(data, desc, out_off)
        lens_h, crcs_h = lens.cpu().tolist(), crcs.cpu().tolist()
        out_h = out.cpu().numpy()
        blocks = [out_h[o:o + ln].tobytes()
                  for (_, _, o), ln in zip(rows, lens_h)]
        # F's input: the frames the PUT stores (frame_chunk's rule).
        bodies, types = [], []
        rawv = memoryview(raw)
        for (i0, sz, _), blk, crc in zip(rows, blocks, crcs_h):
            t = 0 if len(blk) < sz else 1
            types.append(t)
            bodies.append(struct.pack("<I", crc)
                          + (blk if t == 0 else bytes(rawv[i0:i0 + sz])))
        frows, off, fo = [], 0, 0
        for t, b, sz in zip(types, bodies, sizes):
            frows.append((t, off, len(b), fo, sz))
            off += len(b)
            fo += sz
        fdesc = torch.tensor(frows, dtype=torch.int64).cuda()
        fdata = torch.frombuffer(bytearray(b"".join(bodies)),
                                 dtype=torch.uint8).cuda()
        reps = 20 if n < 4097 else 3
        e_ms = time_calls(lambda x: s2_cuda.compress_cuda(x, desc, out_off),
                          [data], reps)
        f_ms = time_calls(lambda x: s2_cuda.decompress_cuda(x, fdesc, fo),
                          [fdata], reps)
        e_plain = f_plain = None
        if kind == "text" and n < 4097:
            cd, cdesc = data.cpu(), desc.cpu()
            t0 = time.perf_counter()
            s2.compress_plain(cd, cdesc, out_off)
            e_plain = 1e3 * (time.perf_counter() - t0)
            fd, fdd = fdata.cpu(), fdesc.cpu()
            t0 = time.perf_counter()
            s2.decompress_plain(fd, fdd, fo)
            f_plain = 1e3 * (time.perf_counter() - t0)
        stored = sum(len(b) for b in blocks)
        e_bytes = len(raw) + desc.numel() * 8 + stored + 16 * n
        f_bytes = fdata.numel() + fdesc.numel() * 8 + fo + n
        for name, ms, plain_ms, nbytes in (
                ("s2_compress", e_ms, e_plain, e_bytes),
                ("s2_decompress", f_ms, f_plain, f_bytes)):
            bound = 1e3 * nbytes / HBM_BYTES_PER_S
            shapes[name].append({
                "data": kind, "chunks": n, "raw_bytes": len(raw),
                "block_bytes": stored,
                "ms": ms, "gbps_raw": len(raw) / ms / 1e6,
                "plain_ms": plain_ms, "bound_ms": bound,
                "share_of_bound": bound / ms, "bound_by": "bytes",
                "launches_4n": (by_chunks[name].get(str(n), 0)
                                if kind == "text" else 0)})
            log(f"{name} {n} chunks of {kind} ({len(raw)} B raw, {stored} B of "
                f"blocks): {ms:.4f} ms a call ({len(raw) / ms / 1e6:.3f} "
                f"GB/s of raw), plain "
                f"{'not run' if plain_ms is None else f'{plain_ms:.1f} ms'}"
                f", bound {bound:.5f} ms ({100 * bound / ms:.3f}% of "
                f"bound), launches of {n} chunks in 4n "
                f"{shapes[name][-1]['launches_4n']}")
        del data, out, fdata
    rows = []
    for name, line in (("s2_compress", 115), ("s2_decompress", 199)):
        main = next(r for r in shapes[name]
                    if r["chunks"] == 128 and r["data"] == "text")
        rows.append({
            "name": name, "route": "cuda",
            "source": "minio_tpu_torch/csrc/s2.cu",
            "replaces": f"minio_tpu/ops/s2.py:{line}",
            "replaces_note": "no TPU kernel: minio_tpu/native/snappy.c "
                             "through ops/s2.py compress_block, "
                             "decompress_block and crc32c on the host",
            "checked": True,
            "launches": launches[name]["config_compression"],
            "launches_by_path": launches[name],
            "launches_4n_by_chunks": by_chunks[name],
            "max_abs_err": errs[name], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "chunks": 128,
            "shapes": shapes[name]})
    return rows


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


def aes_timed() -> tuple:
    """Phase 5's launches of kernels C and D, (label, packages, plaintext
    lengths, AADs, inputs, replays): every shape 4k launches (the
    32-byte object-key seal with AAD b"OEK" of every PUT and GET; a
    256 MiB + 12,345 B object's batches of the port's batch
    (api/transforms.packages_per_launch), its closing 32 full packages
    and its 12,345 B tail alone; a ranged GET's 64), a 1 MiB gather of
    16, the closing 33 in one launch, and the object's 4,097 packages in
    one launch. Inputs cycle past the 50 MB L2 where small."""
    from minio_tpu_torch.api.transforms import packages_per_launch

    main = packages_per_launch("cuda")

    def seq(p):
        return [struct.pack("<Q", i) for i in range(p)]

    return (("key seal", 1, [32], [b"OEK"], 64, 400),
            ("tail", 1, [12_345], seq(1), 64, 400),
            ("gather", 16, [PACKAGE] * 16, seq(16), 64, 200),
            ("closing", 32, [PACKAGE] * 32, seq(32), 32, 100),
            ("closing with tail", 33, [PACKAGE] * 32 + [12_345], seq(33),
             32, 100),
            ("ranged window", 64, [PACKAGE] * 64, seq(64), 16, 100),
            ("batch", main, [PACKAGE] * main, seq(main), 8, 50),
            ("object", 4097, [PACKAGE] * 4096 + [12_345], seq(4097), 1, 4))


def time_aes_kernels(rng, launches: dict, errs: dict) -> list[dict]:
    """Phase 5 for kernels C and D: CUDA-graph replay at aes_timed(), the
    plain versions' times, and the bound: the larger of the bytes in and
    out over HBM_BYTES_PER_S and AES_GCM_OPS_PER_BLOCK a 16-byte block
    (its plaintext, its AAD and its lengths block) over INT32_OPS_PER_S.
    `launches` holds each kernel's launches by main path, and 4k's by
    package count under "aes_by_packages"."""
    from minio_tpu_torch.api.transforms import packages_per_launch
    from minio_tpu_torch.ops import aes_gcm as plain, aes_gcm_cuda as kc
    from minio_tpu_torch.utils.timing import time_calls, time_graph

    key = rng.bytes(32)
    main_batch = packages_per_launch("cuda")
    by_packages = launches["aes_by_packages"]
    shapes = {"seal": [], "open": []}
    for label, p, lengths, aads, n_inputs, reps in aes_timed():
        batches = [aes_batch(rng, lengths, aads) for _ in range(n_inputs)]
        desc, _, nonces, aad, n = batches[0]
        odesc = plain.open_desc(desc)
        plen = sum(lengths)
        datas = [b[1] for b in batches]
        wires = [kc.seal_cuda(key, x, desc, nonces, aad, n) for x in datas]
        blocks = sum(-(-ln // 16) + -(-len(a) // 16) + 1
                     for ln, a in zip(lengths, aads))
        ops = blocks * AES_GCM_OPS_PER_BLOCK
        for kind, fn, plain_fn, inputs in (
                ("seal",
                 lambda x: kc.seal_cuda(key, x, desc, nonces, aad, n),
                 lambda x: plain.seal_plain(key, x, desc, nonces, aad, n),
                 datas),
                ("open",
                 lambda w: kc.open_cuda(key, w, odesc, aad, plen),
                 lambda w: plain.open_plain(key, w, odesc, aad, plen),
                 wires)):
            ms = time_graph(fn, inputs, reps)
            plain_ms = time_calls(plain_fn, inputs[:1], 1)
            nbytes = plen + n + desc.numel() * 8 + aad.numel() + (
                nonces.numel() if kind == "seal" else p)
            bound = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                              ops / INT32_OPS_PER_S)
            name = f"aes_gcm_{kind}"
            shapes[kind].append({
                "shape": label, "packages": p, "plaintext_bytes": plen,
                "cluster": kc.cluster_size(p), "ms": ms,
                "us_per_launch": 1e3 * ms, "gbps": plen / ms / 1e6,
                "plain_ms": plain_ms, "bound_ms": bound,
                "share_of_bound": bound / ms,
                "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / INT32_OPS_PER_S else "operations",
                "launches_4k": by_packages[name].get(str(p), 0)})
            log(f"aes_gcm {kind} {label}, {p} packages ({plen} B, cluster "
                f"{kc.cluster_size(p)}): {ms:.5f} ms a launch "
                f"({plen / ms / 1e6:.2f} GB/s), plain {plain_ms:.3f} ms, "
                f"bound {bound:.3e} ms ({100 * bound / ms:.1f}% of bound), "
                f"launches of {p} packages in 4k "
                f"{shapes[kind][-1]['launches_4k']}")
        del batches, datas, wires
    rows = []
    for kind, name, line in (("seal", "aes_gcm_seal", 205),
                             ("open", "aes_gcm_open", 319)):
        main = next(r for r in shapes[kind] if r["packages"] == main_batch)
        rows.append({
            "name": name, "route": "cuda",
            "source": "minio_tpu_torch/csrc/aes_gcm.cu",
            "replaces": f"minio_tpu/api/transforms.py:{line}",
            "replaces_note": "no TPU kernel: cryptography's AESGCM on the "
                             "host", "checked": True,
            "launches": sum(launches[name].values()),
            "launches_by_path": launches[name],
            "launches_4k_by_packages": by_packages[name],
            "max_abs_err": max(errs[name], errs["aes_gcm_kat"]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "packages": main_batch,
            "shapes": shapes[kind]})
    return rows


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
    t0 = time.perf_counter()
    errs = check_kernels(rng)
    log(f"kernel checks (phase 3) {time.perf_counter() - t0:.1f} s")
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
    t0 = time.perf_counter()
    sse_line, sse_launches = run_sse()
    log(f"SSE phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    admission_line, admission_launches = run_admission()
    log(f"admission phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    obs_line, obs_launches = run_observability()
    obs_line["plane_cost"] = plane_cost()
    log(f"observability phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cfg_line, cfg_launches = run_config_compression()
    log(f"config/compression phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lql_line, lql_launches, lql_system_objects = run_lock_quota_lifecycle()
    lql_line["phase_seconds"] = time.perf_counter() - t0
    log(f"lock/quota/lifecycle phase {lql_line['phase_seconds']:.1f} s")
    t0 = time.perf_counter()
    tier_line, tier_launches, tier_shapes = run_tiering()
    tier_line["phase_seconds"] = time.perf_counter() - t0
    log(f"tiering phase {tier_line['phase_seconds']:.1f} s")
    t0 = time.perf_counter()
    idp_line, idp_launches, idp_shapes = run_identity()
    idp_line["phase_seconds"] = time.perf_counter() - t0
    log(f"identity phase {idp_line['phase_seconds']:.1f} s")
    by_path = {name: {"put_get_heal": launches[name],
                      "object_layer": object_launches[name],
                      "s3_plane": s3_launches[name],
                      "codecs": codec_launches[name],
                      "s3_core": core_launches[name],
                      "self_heal": heal_launches[name],
                      "s3_sse": sse_launches[name],
                      "admission": admission_launches[name],
                      "observability": obs_launches[name],
                      "config_compression": cfg_launches[name],
                      "lock_quota_lifecycle": lql_launches[name],
                      "tiering": tier_launches[name],
                      "identity": idp_launches[name]}
               for name in launches}
    by_path["gf_by_shape"] = heal_line["gf_apply_by_shape"]
    by_path["aes_by_packages"] = sse_line["aes_launches_by_packages"]
    by_path["s2_by_chunks"] = cfg_line["s2_launches_by_chunks"]
    gc.callbacks.remove(on_gc)
    check_system_object_kernels(rng, errs, lql_system_objects)
    check_tier_kernels(rng, errs, tier_shapes["res"], tier_shapes["aes"],
                       tier_shapes["s2"])
    check_identity_kernels(rng, errs, idp_shapes["res"], idp_shapes["aes"])
    log(f"collector passes over 20 ms in the main paths (generation, s): "
        f"{PAUSES}")
    log(f"hedge windows restarted after an oversleeping wait: {RESTARTS}")
    drivers_line["collector_pauses"] = PAUSES
    drivers_line["hedge_windows_restarted"] = RESTARTS
    t0 = time.perf_counter()
    kernels = time_kernels(rng, by_path, errs)
    kernels += time_aes_kernels(rng, by_path, errs)
    kernels += time_s2_kernels(rng, by_path, errs)
    log(f"kernel timings (phase 5) {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} never launched on the "
                                 "main paths")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"object_layer": object_line}), flush=True)
    print(json.dumps({"s3_plane": s3_line}), flush=True)
    print(json.dumps({"pipelined": drivers_line}), flush=True)
    print(json.dumps({"codecs": codecs_line}), flush=True)
    print(json.dumps({"s3_core": core_line}), flush=True)
    print(json.dumps({"self_heal": heal_line}), flush=True)
    print(json.dumps({"sse": sse_line}), flush=True)
    print(json.dumps({"admission": admission_line}), flush=True)
    print(json.dumps({"observability": obs_line}), flush=True)
    print(json.dumps({"config_compression": cfg_line}), flush=True)
    print(json.dumps({"lock_quota_lifecycle": lql_line}), flush=True)
    print(json.dumps({"tiering": tier_line}), flush=True)
    print(json.dumps({"identity": idp_line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

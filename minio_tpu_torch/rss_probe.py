"""Where a server's first encrypted PUT and GET put the process's resident
memory: `tests/test_torch_cuda.py::test_sse_bounded_rss_on_card`'s
Server and 192 MiB SSE-S3 object, each run in a fresh process, once as
the server starts (`Server._warm` on) and once with that warm-up left
out, so the first request sets the same state up inside its own window.

    python -m minio_tpu_torch.rss_probe

For each run it prints one JSON line: the resident growth of the
server's start, of the first SSE-S3 PUT (peak, sampled every 5 ms, and
at its end), of a second PUT and of the first GET (peak); the first
PUT's growth by kind of mapping from /proc/self/smaps (thread stacks of
8 MiB, pinned host memory, allocator heaps by size, the rest) and the
threads it started. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

SIZE = 192 << 20
DATA = Path(__file__).resolve().parent.parent / ".smoke_data"


def _rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _kind(name: str, size: int) -> str:
    """The kind of a mapping: glibc's 8 MiB thread stacks (+ guard), the
    CUDA runtime's pinned host memory (mapped from /dev/zero), other anonymous
    memory by size (allocator heaps and large chunks), or files."""
    if name:
        return "pinned" if name == "/dev/zero" else (
            "heap" if name == "[heap]" else "files")
    if size in (8 << 20, (8 << 20) + 4096):
        return "stacks 8 MiB"
    if size >= 16 << 20:
        return "anon >= 16 MiB"
    return "anon 1-16 MiB" if size >= 1 << 20 else "anon < 1 MiB"


def _smaps() -> dict:
    out: dict = {}
    kind = None
    with open("/proc/self/smaps") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 5 and "-" in parts[0] and ":" in parts[3]:
                lo, hi = (int(x, 16) for x in parts[0].split("-"))
                kind = _kind(parts[5] if len(parts) > 5 else "", hi - lo)
            elif parts and parts[0] == "Rss:":
                out[kind] = out.get(kind, 0) + int(parts[1]) * 1024
    return out


def _peak(fn) -> tuple:
    """(fn's result, peak resident growth, growth at its end)."""
    base = _rss()
    peak = [base]
    done = threading.Event()

    def sample():
        while not done.wait(0.005):
            peak[0] = max(peak[0], _rss())

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        res = fn()
    finally:
        done.set()
        t.join()
    end = _rss()
    return res, max(peak[0], end) - base, end - base


def run(warm: bool) -> dict:
    """One server, as the card test builds it; its first PUT, a second
    PUT and the first GET of an SSE-S3 object of SIZE bytes."""
    from . import entry
    from .api.client import S3Client
    from .server import Server

    if not warm:
        Server._warm = lambda self: None
    payload = np.random.default_rng(50).bytes(SIZE)
    DATA.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(dir=DATA))
    out: dict = {"warm": warm, "size": SIZE}
    with entry._insecure_ssec():
        t0 = _rss()
        server = Server([str(root / "d{1...16}")], port=0,
                        root_user=entry.S3_ACCESS,
                        root_password=entry.S3_SECRET, default_parity=4,
                        device="cuda")
        server.s3.start()
        out["start_growth"] = _rss() - t0
        try:
            c = S3Client(server.endpoint, entry.S3_ACCESS, entry.S3_SECRET)
            assert c.request("PUT", f"/{entry.S3_BUCKET}")[0] == 200
            headers = entry.sse_put_headers("sse-s3")
            torch.cuda.synchronize()
            before, threads0 = _smaps(), threading.active_count()
            t1 = time.perf_counter()
            (status, _, _), out["put_peak"], out["put_end"] = _peak(
                lambda: c.put_stream(f"/{entry.S3_BUCKET}/sse",
                                     entry._PayloadReader(payload), SIZE,
                                     headers))
            out["put_seconds"] = time.perf_counter() - t1
            after = _smaps()
            out["put_by_kind"] = {k: after.get(k, 0) - before.get(k, 0)
                                  for k in sorted(set(before) | set(after))}
            out["put_threads"] = [threads0, threading.active_count()]
            assert status == 200
            (status, _, _), out["put2_peak"], _ = _peak(
                lambda: c.put_stream(f"/{entry.S3_BUCKET}/sse2",
                                     entry._PayloadReader(payload), SIZE,
                                     headers))
            assert status == 200
            sink = entry._Compare(payload)
            (status, _, _), out["get_peak"], _ = _peak(
                lambda: c.get_stream(f"/{entry.S3_BUCKET}/sse", sink))
            assert status == 200 and sink.ok
        finally:
            server.stop()
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("rss_probe: no CUDA device available", file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        print("RUN " + json.dumps(run(sys.argv[1] == "warm")), flush=True)
        return 0
    print(card_line(), flush=True)
    for mode in ("cold", "warm", "warm", "cold"):
        p = subprocess.run([sys.executable, "-m", "minio_tpu_torch.rss_probe",
                            mode], capture_output=True, text=True,
                           timeout=600)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("RUN ")]
        if p.returncode or not lines:
            print(p.stderr[-3000:], file=sys.stderr)
            return 1
        print(lines[-1][len("RUN "):], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

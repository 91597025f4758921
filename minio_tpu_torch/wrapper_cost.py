"""The cost of the drive health wrapper on the server paths: the entry
points of chip_smoke.py's phases 4e (s3_put_get_heal), 4i (s3_core), 4j
(self_heal) and 4k (s3_sse), at the smoke's sizes, each run with the
wrapper's per-op deadlines on (every drive op through its drive's own
thread pool, as a server runs) and off (the `drive` subsystem disabled:
each op called on the caller's thread), in turns on, off, off, on, in
one process on one card.

    python -m minio_tpu_torch.wrapper_cost [--phases 4e,4i,4j,4k]

Prints one line a run (phase, mode, seconds of the whole call and of
each step) and one JSON object {"wrapper_cost": ...} with every run and,
for each phase, the mean seconds on and off. Every run's checks must
pass. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import entry
from .ops import _build
from .storage.diskcheck import robust_overrides

OBJECT_SIZE = (256 << 20) + 12_345
SMALL_SIZES = (1 << 10, (4 << 10) + 1, 33 << 10, 100 << 10)
DATA = Path(__file__).resolve().parent.parent / ".smoke_data"

# Each phase's call, as chip_smoke.py makes it.
PHASES = {
    "4e": lambda d: entry.s3_put_get_heal(
        d, OBJECT_SIZE, device="cuda", part_size=16 << 20, parts=8,
        last_part=12_345, small_count=256, small_sizes=SMALL_SIZES,
        page=100, concurrent=4, seed=4),
    "4i": lambda d: entry.s3_core(
        d, OBJECT_SIZE, device="cuda", small_count=256, small_size=1 << 10,
        page=100, seed=30),
    "4j": lambda d: entry.self_heal(
        d, OBJECT_SIZE, device="cuda", small_count=256,
        small_sizes=SMALL_SIZES, seed=40),
    "4k": lambda d: entry.s3_sse(d, OBJECT_SIZE, device="cuda", seed=50),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run(phase: str, wrapped: bool) -> dict:
    DATA.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=DATA)
    try:
        # The env for the Server each phase builds (it applies the drive
        # subsystem), the override for the code that runs outside one.
        with entry.env_vars(MTPU_DRIVE_ENABLE="on" if wrapped else "off"), \
                robust_overrides(enabled=wrapped):
            t0 = time.perf_counter()
            res = PHASES[phase](tmp)
            seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    failed = [k for k, ok in res["checks"].items() if ok is not True]
    if failed:
        raise AssertionError(f"{phase} checks failed: {failed}")
    return {"phase": phase, "wrapped": wrapped, "seconds": seconds,
            "steps": res["seconds"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="4e,4i,4j,4k")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wrapper_cost: no CUDA device available", file=sys.stderr)
        return 2
    card = card_line()
    _build.build_all()
    runs = []
    for phase in args.phases.split(","):
        for wrapped in (True, False, False, True):
            r = run(phase, wrapped)
            runs.append(r)
            print(f"{phase} wrapper {'on' if wrapped else 'off'}: "
                  f"{r['seconds']:.3f} s, steps {r['steps']} ({card})",
                  flush=True)
    means = {}
    for phase in args.phases.split(","):
        on = [r["seconds"] for r in runs if r["phase"] == phase
              and r["wrapped"]]
        off = [r["seconds"] for r in runs if r["phase"] == phase
               and not r["wrapped"]]
        means[phase] = {"on": sum(on) / len(on), "off": sum(off) / len(off),
                        "on_runs": on, "off_runs": off}
    print(json.dumps({"wrapper_cost": {"card": card, "means": means,
                                       "runs": runs}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where a launch of kernels C and D spends its time on the card: the
parts of csrc/aes_gcm.cu timed from variants of the source, each leaving
one part out, built beside the real library and timed the same way.

    python -m minio_tpu_torch.aes_gcm_parts

Variants (text edits of a copy of the source; nothing of them is in the
repo's kernel): `setup_only` launches the setup kernel alone; `no_aes`
drops the message blocks' AES (the keystream is the counter block);
`no_ghash_mul` drops the Horner product by H^CT; `no_aes_no_ghash` both;
`no_combine_mul` drops each thread's closing product by its weight;
`no_pdl` launches the main kernel after the setup has ended;
`cluster2/4/8` fix the cluster size. Each part's time is the full
kernel's less its variant's, at the seal shapes of the main paths (the
32-byte key seal, 16, 127 and 4,097 packages); the full seal is first
held exact to the plain version, and the full open is timed beside it.
Times are a launch's own, from CUDA-graph replay, two turns each. Prints
one line a shape and variant, then one JSON object. Exits non-zero
without a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import struct
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .ops import _build, aes_gcm as plain
from .utils.timing import time_graph

_LOOP_MUL = "      if (seen) y = gmul_tab(gt, y);\n"
_AES = "          aes256(tab, rk, k0, k1, k2, k3);\n"
_COMBINE = ("    uint4 z = seen ? to_le(gf_mul_call(from_le(y), weight))\n"
            "                   : make_uint4(0, 0, 0, 0);\n")
_MAIN = "  const uint4* w = (const uint4*)ws;\n"
_CLUSTER = "int cluster_size(long long packages) {\n"
VARIANTS = {
    "full": [],
    "setup_only": [(_MAIN, "  if (packages > 0) return 0;\n" + _MAIN)],
    "no_aes": [(_AES, "")],
    "no_ghash_mul": [(_LOOP_MUL, "")],
    "no_aes_no_ghash": [(_AES, ""), (_LOOP_MUL, "")],
    "no_combine_mul": [(_COMBINE, "    uint4 z = y;\n")],
    "no_pdl": [("  cfg.numAttrs = 2;\n", "  cfg.numAttrs = 1;\n")],
    **{f"cluster{c}": [(_CLUSTER, f"{_CLUSTER}  return {c};\n")]
       for c in (2, 4, 8)},
}
# (packages, plaintext lengths, AADs, inputs, replays)
SHAPES = ((1, [32], [b"OEK"], 16, 400),
          (16, [65_536] * 16, None, 64, 200),
          (127, [65_536] * 127, None, 8, 50),
          (4097, [65_536] * 4096 + [12_345], None, 1, 4))


def _build_variant(name: str):
    src = (_build.CSRC / "aes_gcm.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in the "
                               "source once")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / "aes_gcm_parts"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    so = out / f"lib{name}.so"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    run = subprocess.run([_build._nvcc(), *flags, "-o", str(so),
                          str(out / f"{name}.cu")], capture_output=True,
                         text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{run.stdout}"
                           f"{run.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build.SIGNATURES["aes_gcm"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return name, lib


def _batch(rng, lengths, aads):
    desc = plain.seal_desc(lengths, [len(a) for a in aads])
    n = int(desc[:, 1].sum())

    def dev(a):
        return torch.from_numpy(a).cuda()

    return (dev(desc), dev(rng.integers(0, 256, n, dtype=np.uint8)),
            dev(rng.integers(0, 256, (len(lengths), 12), dtype=np.uint8)),
            dev(np.frombuffer(b"".join(aads), dtype=np.uint8).copy()),
            n + plain.OVERHEAD * len(lengths))


def _seal(lib, key, x, desc, nonces, aad, n):
    out = torch.empty(n, dtype=torch.uint8, device="cuda")
    ws = torch.empty(lib.aes_gcm_workspace_bytes(), dtype=torch.uint8,
                     device="cuda")
    _build.check(lib.aes_gcm_seal_launch(
        x.data_ptr(), desc.data_ptr(), nonces.data_ptr(), aad.data_ptr(),
        out.data_ptr(), desc.shape[0], key, ws.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "aes_gcm_seal_launch")
    return out


def _open(lib, key, w, odesc, aad, n):
    out = torch.empty(n, dtype=torch.uint8, device="cuda")
    ok = torch.empty(odesc.shape[0], dtype=torch.uint8, device="cuda")
    ws = torch.empty(lib.aes_gcm_workspace_bytes(), dtype=torch.uint8,
                     device="cuda")
    _build.check(lib.aes_gcm_open_launch(
        w.data_ptr(), odesc.data_ptr(), aad.data_ptr(), out.data_ptr(),
        ok.data_ptr(), odesc.shape[0], key, ws.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "aes_gcm_open_launch")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("aes_gcm_parts: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(pool.map(_build_variant, VARIANTS))
    rng = np.random.default_rng(11)
    key = rng.bytes(32)
    result = {}
    for p, lengths, aads, n_inputs, reps in SHAPES:
        aads = aads or [struct.pack("<Q", i) for i in range(p)]
        batches = [_batch(rng, lengths, aads) for _ in range(n_inputs)]
        desc, _, nonces, aad, n = batches[0]
        datas = [b[1] for b in batches]
        want = plain.seal_plain(key, datas[0], desc, nonces, aad, n)
        got = _seal(libs["full"], key, datas[0], desc, nonces, aad, n)
        if not torch.equal(got, want):
            raise AssertionError(f"full variant differs at {p} packages")
        odesc = plain.open_desc(desc)
        wires = [_seal(libs["full"], key, x, desc, nonces, aad, n)
                 for x in datas]
        times = {name: [] for name in libs}
        times["open_full"] = []
        for _ in range(2):
            for name, lib in libs.items():
                times[name].append(time_graph(
                    lambda x: _seal(lib, key, x, desc, nonces, aad, n),
                    datas, reps))
            times["open_full"].append(time_graph(
                lambda w: _open(libs["full"], key, w, odesc, aad,
                                sum(lengths)), wires, reps))
        ms = {name: min(t) for name, t in times.items()}
        parts = {"setup": ms["setup_only"],
                 "aes": ms["full"] - ms["no_aes"],
                 "ghash": ms["full"] - ms["no_ghash_mul"],
                 "combine": ms["full"] - ms["no_combine_mul"],
                 "rest": ms["no_aes_no_ghash"],
                 "pdl_saves": ms["no_pdl"] - ms["full"]}
        for name, t in times.items():
            print(f"{p:5d} packages {name:16s} ms {t}", flush=True)
        print(f"{p:5d} packages parts (ms): {parts}", flush=True)
        result[str(p)] = {"ms": times, "parts_ms": parts}
        del batches, datas, wires
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "aes_gcm_parts": result}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build and load the CUDA kernels of `minio_tpu_torch/csrc`.

Each `.cu` source is compiled at first use by `nvcc` into a shared library
with a plain C interface under `minio_tpu_torch/_build/`, and loaded with
ctypes. The library's file name carries a hash of the source and the
flags, so an edited source builds anew and an unchanged one loads the
library already there. `build_all()` starts one `nvcc` per source at once.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# argtypes of each library's C entry points; every pointer and the stream
# are c_void_p so ctypes never truncates them to 32 bits.
_VP, _I, _LL, _U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_uint64)
SIGNATURES = {
    "gf_apply": {
        "gf_apply_launch": [_VP, _VP, _VP, _LL, _I, _I, _LL, _VP],
        "gf_apply_smem_bytes": [_I, _I],
    },
    "highwayhash": {
        "hh256_launch": [_VP, _LL, _LL, _LL, _VP, _U64, _U64, _U64, _U64,
                         _VP],
        "hh256_verify_launch": [_VP, _LL, _LL, _LL, _VP, _LL, _VP, _U64,
                                _U64, _U64, _U64, _VP],
        "hh256_verify_grouped_launch": [_VP, _LL, _LL, _LL, _VP, _LL, _LL,
                                        _LL, _LL, _VP, _U64, _U64, _U64,
                                        _U64, _VP],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report of the last build of each source (registers,
# shared memory, spills), for the smoke run to print.
BUILD_LOGS: dict[str, str] = {}


class LaunchCounter:
    """Kernel launches made by this process, counted by the kernel's
    wrapper where it launches and nowhere else. Request threads of the
    S3 server launch at once, so the count takes a lock."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        return self._n

    def reset(self, value: int = 0) -> None:
        with self._lock:
            self._n = value


class ShapeLaunchCounter:
    """A kernel's launches by shape key, counted beside its LaunchCounter
    where it launches and nowhere else."""

    def __init__(self):
        self._n: dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, key: str) -> None:
        with self._lock:
            self._n[key] = self._n.get(key, 0) + 1

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._n)

    def reset(self) -> None:
        with self._lock:
            self._n = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    out.with_suffix(".log").write_text(log)
    BUILD_LOGS[name] = log


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    log = path.with_suffix(".log")
    if name not in BUILD_LOGS and log.exists():
        BUILD_LOGS[name] = log.read_text()
    return lib


def build_all(names=tuple(SIGNATURES)) -> dict[str, ctypes.CDLL]:
    """Build every missing library in parallel (one nvcc per source) and
    load them all."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        want = [n for n in names if n not in _libs]
        paths = {n: _lib_path(n) for n in want}
        procs = {n: _start(n, p) for n, p in paths.items() if not p.exists()}
        errors = []
        for n, proc in procs.items():
            try:
                _finish(n, paths[n], proc)
            except RuntimeError as exc:
                errors.append(exc)
        if errors:
            raise errors[0]
        for n in want:
            _libs[n] = _load(n, paths[n])
        return {n: _libs[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all((name,))[name]
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")

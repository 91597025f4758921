"""minio_tpu_torch stands alone: no module of the port, and not
chip_smoke.py, imports jax or anything of minio_tpu, or any third-party
package but torch and numpy (the card machine has no msgpack, for one),
and an entry point asked for the card on a host without one raises
instead of running on the CPU."""

import ast
import io
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "minio_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "minio_tpu")


def _third_party(module: str) -> bool:
    top = module.split(".")[0]
    return top not in sys.stdlib_module_names and top not in (
        "torch", "numpy", "minio_tpu_torch", "__future__")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_minio_tpu_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_third_party_imports_but_torch_and_numpy(path):
    bad = [n for n in _imports(path) if _third_party(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_fresh_interpreter_loads_neither():
    code = (
        "import sys, minio_tpu_torch.entry, minio_tpu_torch.erasure.streaming\n"
        "import minio_tpu_torch.object.sets, minio_tpu_torch.storage.local\n"
        "import minio_tpu_torch.server, minio_tpu_torch.cli\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'minio_tpu')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_cuda_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the calls would run on it")
    from minio_tpu_torch.crypto import AESGCM, LocalKMS, SSEConfig
    from minio_tpu_torch.entry import (entry, object_put_get_heal,
                                       put_get_heal, s3_sse)
    from minio_tpu_torch.erasure import device_engine
    from minio_tpu_torch.erasure.bitrot import StreamingBitrotWriter
    from minio_tpu_torch.erasure.codec import Erasure, cached_erasure
    from minio_tpu_torch.object.erasure_objects import ErasureObjects
    from minio_tpu_torch.object.sets import ErasureSets
    from minio_tpu_torch.storage.local import LocalStorage
    from minio_tpu_torch.utils.device import resolve_device

    calls = [
        lambda: resolve_device(),
        lambda: entry(),
        lambda: Erasure(12, 4, 1 << 20),
        lambda: device_engine.for_geometry(12, 4),
        lambda: StreamingBitrotWriter(io.BytesIO()),
        lambda: put_get_heal(tmp_path, 1000),
        lambda: cached_erasure(12, 4, 1 << 20),
        lambda: LocalStorage(str(tmp_path / "d0")),
        lambda: ErasureObjects([None] * 16),
        lambda: ErasureSets([None] * 16, 16),
        lambda: object_put_get_heal(tmp_path, 1000),
        lambda: AESGCM(bytes(32)),
        lambda: SSEConfig("secret"),
        lambda: LocalKMS("secret"),
        lambda: s3_sse(tmp_path, 1000),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not any(tmp_path.iterdir())  # nothing ran on the CPU instead

"""The port stands alone: it imports no JAX, flax, msgpack (the card's
machine has none: the port reads flax's files with its own decoder) or
`miseg_tpu`, and
`chip_smoke.py` neither imports them nor reports success without a card
or without the rest of the repository."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "msgpack", "miseg_tpu")
# every kernel of the port is CUDA C++ built by nvcc: no Triton anywhere
NOT_TRITON = ("triton",)

_IMPORT_ALL = """
import importlib, pkgutil, sys
import miseg_tpu_torch
names = [m.name for m in pkgutil.walk_packages(miseg_tpu_torch.__path__, "miseg_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "jaxlib", "msgpack", "miseg_tpu"))
print(len(names), "modules;", "forbidden:", bad)
sys.exit(1 if bad or len(names) < 20 else 0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_package_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


_SOURCES = ["chip_smoke.py", *sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "miseg_tpu_torch").rglob("*.py")
    if "_build" not in p.parts)]  # _build holds kernel build outputs


@pytest.mark.parametrize("path", _SOURCES)
def test_no_forbidden_imports_in_source(path):
    assert not _imported_roots(ROOT / path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", _SOURCES)
def test_no_triton_in_source(path):
    assert not _imported_roots(ROOT / path) & set(NOT_TRITON)
    assert "triton.jit" not in (ROOT / path).read_text()


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = _run_smoke(ROOT, env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = _run_smoke(tmp_path, env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


_FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: writes the -o target, or fails when asked to
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
if [ -n "$FAKE_NVCC_FAIL" ]; then echo "error: fake failure"; exit 2; fi
echo "ptxas info    : Used 1 registers" && echo built > "$out"
"""


def test_kernel_build_orchestration(tmp_path, monkeypatch):
    """build_all() runs one compiler per source into a hashed file, skips
    current builds, and raises with the compiler's log on failure."""
    from miseg_tpu_torch.ops.kernels import build
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    build.build_all()
    built = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert built == [build.library_path(n).name for n in build.sources()]
    assert all("Used 1 registers" in build.build_log[n] for n in build.sources())
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    build.build_all()  # every build is current: the compiler never runs
    for p in (tmp_path / "out").iterdir():
        p.unlink()
    with pytest.raises(RuntimeError, match="fake failure"):
        build.build_all()
    assert not any((tmp_path / "out").iterdir())  # no partial library left


def test_kernel_build_name_follows_shared_headers(tmp_path, monkeypatch):
    """A build is keyed by its source and every shared header, so editing a
    header never loads a stale library."""
    from miseg_tpu_torch.ops.kernels import build
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert build.library_path("k") != first

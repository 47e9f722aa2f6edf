"""Import hygiene of the port: ``import hetmogp_tpu_torch`` loads neither
JAX, nor the JAX package, nor triton, and does not initialise CUDA; the
kernel library is built and loaded only when a CUDA tensor reaches it."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "hetmogp_tpu_torch"

_CHECK = r"""
import sys

import hetmogp_tpu_torch  # noqa: F401
import hetmogp_tpu_torch.ops.cuda_kernels  # noqa: F401
import torch

bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "hetmogp_tpu", "triton"))
if bad:
    print("LOADED:", bad)
    sys.exit(1)
if torch.cuda.is_initialized():
    print("CUDA-INITIALIZED")
    sys.exit(1)
print("CLEAN")
"""


def test_import_loads_no_jax_triton_or_cuda():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _CHECK], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "CLEAN" in proc.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|triton|hetmogp_tpu)(\.|\s|$)",
    re.MULTILINE)


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in PKG.rglob("*.py")))
def test_source_imports_no_jax(path):
    src = (ROOT / path).read_text()
    assert not _FORBIDDEN.findall(src), path


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert not _FORBIDDEN.findall(src)
    assert "hetmogp_tpu_torch" in src

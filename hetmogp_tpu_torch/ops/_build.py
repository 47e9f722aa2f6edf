"""Build the package's CUDA sources into a shared library at first use.

The sources in ``hetmogp_tpu_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, which
``ops/cuda_kernels.py`` loads with ``ctypes``.  The library goes to
``build/hetmogp_tpu_torch/`` under the repository root and its name carries
a hash of the sources and flags, so an edit to a source rebuilds it and an
unchanged tree reuses it.  ``nvcc`` is found through ``CUDA_HOME``,
``PATH`` or ``/usr/local/cuda``; without it the build raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hetmogp_tpu_torch"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else PATH, else the
    toolkit's default ``/usr/local/cuda`` (PyTorch's own search order)."""
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").is_file():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None and (DEFAULT_CUDA_HOME / "bin" / "nvcc").is_file():
        found = str(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
            f"{DEFAULT_CUDA_HOME}/bin): the CUDA "
            "kernels of hetmogp_tpu_torch are compiled at first use and need "
            "the CUDA toolkit; CPU tensors take the plain PyTorch versions "
            "and need no build")
    return found


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhetmogp_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; return its path.

    nvcc's output (``-Xptxas -v``: registers, shared memory and spills of
    each kernel) is kept beside the library as ``<name>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out

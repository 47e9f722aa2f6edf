"""Build the package's CUDA sources into a shared library at first use.

The sources in ``hetmogp_tpu_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a``, one ``nvcc`` per source, all started together, and linked into
one shared library with a plain C interface, which
``ops/cuda_kernels.py`` loads with ``ctypes``.  The library goes to
``build/hetmogp_tpu_torch/`` under the repository root and its name carries
a hash of the sources (``*.cu`` and the ``*.cuh`` they include) and flags,
so an edit to a source rebuilds it and an unchanged tree reuses it.
``nvcc`` is found through ``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``;
without it the build raises.
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
    # the headers too: an edit to a shared .cuh must not reuse a library
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhetmogp_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; return its path.

    Each source compiles to an object in its own ``nvcc`` process, all in
    parallel; one more ``nvcc`` links them.  nvcc's output (``-Xptxas -v``:
    registers, shared memory and spills of each kernel) is kept beside the
    library as ``<name>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        cmd = [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
            *(str(obj) for _, obj, _ in jobs)]
    log, failed = [], None
    for cmd, _, proc in jobs:
        log.append(proc.communicate()[0])
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode)
    if failed is None:
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed = (link, proc.returncode)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(log))
    if failed is not None:
        cmd, rc = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                           + "".join(log))
    os.replace(tmp, out)
    return out

"""Kernel 4's schedule and index arithmetic on the CPU.

Kernel 4's TMA-fed design (``csrc/tril_right_kernel.cu``) runs only on the
card.  Which tiles each persistent block takes, turn by turn
(``csrc/tril_tiles.cuh``), which output each FMA thread holds, which
stages of a tile each warp skips, masks or runs in full, and where each
row-sum partial goes (``csrc/tril_right_plan.cuh``) are plain C++ behind a
``__host__ __device__`` macro that is empty under a host compiler.  So
this file compiles ``csrc/tril_right_plan_host.cpp`` with g++ into
``build/`` and walks every block, turn, tile, thread and stage of one
launch with the loops the kernel runs, at the VE, VM and adjoint shapes of
the flagship, a serving-like one and a ragged one, on the H100's 132 SMs
and on 7 (more turns a block), asserting that

* every output (q, n, k < M) is written exactly once;
* its FMA chain takes m = k .. M - 1 in increasing order, each once, and
  exactly the entries m < k are masked or skipped;
* every row-sum partial is written once, by a lane whose shuffle tree
  covers its warp's columns of that row.

It skips, with the reason, where no g++ is found.  The last test holds
the reading of a ``cuobjdump -sass`` listing by which
``hetmogp_tpu_torch/probes/tril_right.py`` counts the kernel's
instructions on the card to a listing of known content.  The card runs
the kernel itself against cuBLAS and float64 (``chip_smoke.py``,
``right_products_phase``).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import pytest

from hetmogp_tpu_torch.ops import _build

HOST_SOURCES = (_build.CSRC / "tril_right_plan_host.cpp",
                _build.CSRC / "tril_right_plan.cuh",
                _build.CSRC / "tril_tiles.cuh")
STATS = ("outputs", "twice", "never", "chain_faults", "fmas", "masked",
         "skipped", "part_faults", "blocks", "tiles")
BM = BN = 128  # a tile's rows and columns (csrc/tril_right_plan.cuh)
SHAPES = {"VE": (4, 3072, 1024), "VM": (4, 768, 1024),
          "adjoint": (4, 1024, 1024), "serving-like": (4, 8192, 1024),
          "ragged": (3, 1000, 776)}


@pytest.fixture(scope="module")
def walk():
    """``csrc/tril_right_plan_host.cpp`` built with g++ into ``build/``
    (the name carries a hash of the sources) and loaded."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on PATH: the host build of kernel 4's plan "
                    "(csrc/tril_right_plan_host.cpp) needs a C++17 compiler")
    h = hashlib.sha256()
    for src in HOST_SOURCES:
        h.update(src.read_bytes())
    out = _build.BUILD_DIR / f"libtril_right_plan-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o",
                        str(tmp), str(HOST_SOURCES[0])], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.tril_right_plan_walk.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.tril_right_plan_walk.restype = ctypes.c_longlong
    assert lib.tril_right_plan_stats() == len(STATS)

    def run(Q, N, M, sms):
        stats = (ctypes.c_longlong * len(STATS))()
        faults = lib.tril_right_plan_walk(Q, N, M, sms, stats)
        return faults, dict(zip(STATS, stats))

    return run


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_every_output_once_with_its_whole_chain(walk, shape, sms):
    Q, N, M = SHAPES[shape]
    faults, st = walk(Q, N, M, sms)
    R, C = -(-N // BM), -(-M // BN)
    assert faults == 0, st
    assert st["outputs"] == Q * N * M
    assert st["twice"] == st["never"] == 0
    assert st["chain_faults"] == 0 and st["part_faults"] == 0
    assert st["tiles"] == Q * R * C
    assert 0 < st["blocks"] <= sms
    # a thread's chain serves its 8 rows: summed over the tile's 128 rows
    # (those past N included), each column k < M takes M - k entries
    assert 8 * st["fmas"] == Q * R * BM * M * (M + 1) // 2
    # and the skipped and masked entries are the rest of the tile's
    # reduction: m = k0 .. k - 1 of each column, its strict upper half
    upper = sum(w * (w - 1) // 2 for w in (min(BN, M - ct * BN)
                                            for ct in range(C)))
    assert 8 * (st["skipped"] + st["masked"]) == Q * R * BM * upper
    assert st["skipped"] > 0 and st["masked"] > 0


# a cuobjdump -sass listing of two functions, cut to what the probe reads
LISTING = """
\tcode for sm_90a
\t\tFunction : _Z21tril_right_tma_kernel14CUtensorMap_stS_PfS0_iii
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;              /* 0x0000000000007919 */
        /*0020*/                   LDS.128 R4, [R2] ;              /* 0x0000000002047984 */
        /*0030*/                   FFMA R8, R4, R5, R8 ;           /* 0x0000000504087223 */
        /*0040*/                   FFMA R9, R4, R6, R9 ;           /* 0x0000000604097223 */
        /*0050*/                   FSEL R6, R6, RZ, P1 ;           /* 0x000000ff06067208 */
        /*0060*/               @P0 BRA 0x20 ;                      /* 0xfffffffc00000947 */
        /*0070*/                   EXIT ;                          /* 0x000000000000794d */
\t\t..........
\t\tFunction : _Z14row_sum_kernelPKfPfxi
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDG.E R2, [R4.64] ;             /* 0x0000000404027981 */
        /*0010*/                   EXIT ;                          /* 0x000000000000794d */
"""


@pytest.mark.parametrize("kernel, span, mix", [
    ("tril_right_tma_kernel", "0x20-0x60",
     {"LDS": 1, "LDS.128": 1, "FFMA": 2, "select": 1, "branch": 1,
      "instructions": 5}),
    ("row_sum_kernel", "whole kernel",
     {"global": 1, "branch": 1, "instructions": 2}),
])
def test_probe_reads_the_sass_of_a_kernel(kernel, span, mix):
    """``probes/tril_right.py``'s reading of a ``cuobjdump -sass``
    listing: its functions apart, a kernel's loops (a backward branch and
    its target; the whole kernel where there is none) and their
    instruction classes."""
    from hetmogp_tpu_torch.probes import tril_right as probe

    funcs = probe.sass_functions(LISTING)
    assert len(funcs) == 2 and any(kernel in name for name in funcs)
    loops = probe.sass_loops(LISTING, kernel)
    assert len(loops) == 1
    assert loops[0] == {"span": span, **mix}

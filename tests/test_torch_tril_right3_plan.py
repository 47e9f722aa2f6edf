"""Kernel 5's schedule and index arithmetic on the CPU.

Kernel 5's TMA-fed design (``csrc/tril_right3_kernel.cu``) runs only on
the card.  Which tiles, or parts of a tile's reduction, each persistent
block takes turn by turn, the order in which its stages pass through the
ring, where a split tile's two sums meet, and the maps of its splitter
and epilogue (``csrc/tril_right3_plan.cuh``) are plain C++ behind a
``__host__ __device__`` macro that is empty under a host compiler.  So
this file compiles ``csrc/tril_right3_plan_host.cpp`` with g++ into
``build/`` and walks every block, turn, unit and stage of one launch with
the cursor the kernel walks, at the VE, VM, adjoint and serving shapes of
the flagship, a ragged one and a one-tile one, on the H100's 132 SMs and
on 7 (more turns a block), asserting that

* every output tile takes its whole reduction m in [k0, M) once: its
  stages [0, S) once, as one unit or as a head and a tail;
* each of its columns k takes m = k .. M - 1 in increasing order, and
  exactly the entries m < k are masked by the splitter;
* a split tile has one block that writes its partial and one, on the same
  turn or a later one, that adds it: a fixed order, the same in every
  launch, whatever the data;
* the splitter's reads and bf16 writes, the epilogue's accumulators and
  the partials' layout are each one to one;
* the schedule's balance (the mean block's stages over the busiest
  block's, on 132 SMs) is at least 0.9 at the VE, VM, adjoint and serving
  shapes; the VM shape's was 0.818 before column tile 0 was split.

It skips, with the reason, where no g++ is found.  The card runs the
kernel itself against the plain 3-pass version and float64
(``chip_smoke.py``, ``right_products_phase``).  The last test holds the
probes' comparison of two ``cuobjdump -sass`` listings, function by
function, to listings of known content.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import pytest

from hetmogp_tpu_torch.ops import _build

HOST_SOURCES = (_build.CSRC / "tril_right3_plan_host.cpp",
                _build.CSRC / "tril_right3_plan.cuh")
STATS = ("tile_faults", "chain_faults", "split_faults", "map_faults", "macs",
         "masked", "blocks", "units", "split", "busiest", "total",
         "wait_turns")
BM = BN = 128  # a tile's rows and columns
BK = 64        # a stage's depth (csrc/tril_right3_plan.cuh)
SHAPES = {"VE": (4, 3072, 1024), "VM": (4, 768, 1024),
          "adjoint": (4, 1024, 1024), "serving": (4, 65536, 1024),
          "ragged": (3, 1000, 772), "one tile": (1, 100, 128)}


@pytest.fixture(scope="module")
def walk():
    """``csrc/tril_right3_plan_host.cpp`` built with g++ into ``build/``
    (the name carries a hash of the sources) and loaded."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on PATH: the host build of kernel 5's plan "
                    "(csrc/tril_right3_plan_host.cpp) needs a C++17 "
                    "compiler")
    h = hashlib.sha256()
    for src in HOST_SOURCES:
        h.update(src.read_bytes())
    out = _build.BUILD_DIR / f"libtril_right3_plan-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o",
                        str(tmp), str(HOST_SOURCES[0])], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.tril_right3_plan_walk.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.tril_right3_plan_walk.restype = ctypes.c_longlong
    assert lib.tril_right3_plan_stats() == len(STATS)

    def run(Q, N, M, sms):
        stats = (ctypes.c_longlong * len(STATS))()
        faults = lib.tril_right3_plan_walk(Q, N, M, sms, stats)
        return faults, dict(zip(STATS, stats))

    return run


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_every_tile_once_with_its_whole_chain(walk, shape, sms):
    Q, N, M = SHAPES[shape]
    faults, st = walk(Q, N, M, sms)
    R, C = -(-N // BM), -(-M // BN)
    assert faults == 0, st
    assert st["tile_faults"] == st["chain_faults"] == 0
    assert st["split_faults"] == 0 and st["map_faults"] == 0
    assert 0 < st["blocks"] <= sms
    # every tile's stages, once: column tile j reduces from j BN to M
    S = [-(-(M - j * BN) // BK) for j in range(C)]
    assert st["total"] == Q * R * sum(S)
    # each column k < M takes its M - k entries; the splitter masks the
    # rest of the straddling stages' m < k (m < M)
    assert st["macs"] == Q * R * M * (M + 1) // 2
    masked = 0
    for j in range(C):
        k0 = j * BN
        for k in range(k0, min(k0 + BN, M)):
            m_end = min(M, k0 + BK * min(S[j], -(-BN // BK)))
            masked += max(0, min(k, m_end) - k0)
    assert st["masked"] == Q * R * masked
    # a split tile is two units
    split_tiles = Q * R if st["split"] else 0
    assert st["units"] == Q * R * C + split_tiles


def test_split_parts_meet_in_a_fixed_order(walk):
    """At the VM shape the plan splits column tile 0: its writer's unit
    comes before its adder's, on an earlier turn, so the adder finds the
    partial written; the paired shapes split nothing."""
    _, vm = walk(4, 768, 1024, 132)
    assert 0 < vm["split"] < 16
    assert vm["wait_turns"] == 0
    for shape in ("VE", "serving"):
        _, st = walk(*SHAPES[shape], 132)
        assert st["split"] == 0


@pytest.mark.parametrize("shape, least", [("VM", 0.9), ("adjoint", 0.9),
                                          ("VE", 0.9), ("serving", 0.9)])
def test_schedule_balance_on_132_sms(walk, shape, least):
    """The mean block's stages over the busiest block's, on 132 SMs: at
    least 0.9 at the four shapes the probe times (the VM shape's 0.818
    before the split of column tile 0)."""
    _, st = walk(*SHAPES[shape], 132)
    assert st["total"] / 132 / st["busiest"] >= least


# two listings of a kernel that lost its template parameter, cut to what
# the probes read: the parent's <false> and <true> instantiations, and
# this checkout's function, printed at another column
PARENT = """
\t\tFunction : _Z4kernILb0EEvi
        /*0000*/                   LDS.64 R4, [R2] ;          /* 0x0000000002047984 */
                                                              /* 0x000fe40000000800 */
        /*0010*/                   EXIT ;                     /* 0x000000000000794d */
\t\tFunction : _Z4kernILb1EEvi
        /*0000*/                   LD.E.64 R4, [R2.64] ;      /* 0x0000000402047980 */
        /*0010*/                   EXIT ;                     /* 0x000000000000794d */
"""
CHANGE = """
\t\tFunction : _Z4kerni
        /*0000*/       LDS.64 R4, [R2] ;  /* 0x0000000002047984 */
                                          /* 0x000fe40000000800 */
        /*0010*/       EXIT ;             /* 0x000000000000794d */
"""


@pytest.mark.parametrize("change, verdict", [
    (CHANGE, "the same in parent (as void kern<false>(int))"),
    (CHANGE.replace("LDS.64 R4", "LDS.64 R6"), "DIFFERS in parent"),
], ids=["same", "differs"])
def test_probe_holds_a_kernel_to_its_template_instantiation(
        monkeypatch, capsys, change, verdict):
    """``same_sass`` (``probes/tril_right.py``, used by both probes'
    ``--same-sass``): a function is held to its namesake, or, where it has
    none, to those whose demangled names differ in template arguments
    alone; the instructions are compared with their spacing evened; a
    function of the other listing that none was held to is named as
    such."""
    from hetmogp_tpu_torch.probes import tril_right as probe

    names = {"_Z4kernILb0EEvi": "void kern<false>(int)",
             "_Z4kernILb1EEvi": "void kern<true>(int)",
             "_Z4kerni": "kern(int)"}
    monkeypatch.setattr(probe, "demangler", lambda keys: names)
    probe.same_sass(change, PARENT, "parent", "k.cu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"SASS of k.cu: kern(int): {verdict}")
    if verdict.startswith("the same"):
        assert lines[1:] == ["SASS of k.cu: void kern<true>(int): only in "
                             "parent"]

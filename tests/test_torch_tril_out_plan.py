"""Kernel 8's schedule and index arithmetic on the CPU.

Kernel 8's TMA-fed designs (``csrc/tril_out_kernel.cu``: tril(A^T B) in
float32 FFMA, and in three bf16 wgmma passes) run only on the card.
Which lower output tile, or which part of a tile's reduction, each
persistent block takes turn by turn, the order in which its stages pass
through the ring, where the parts of a split tile meet, and the maps of
its threads, partials, splitter and A fragments
(``csrc/tril_out_plan.cuh``) are plain C++ behind a ``__host__
__device__`` macro that is empty under a host compiler.  So this file
compiles ``csrc/tril_out_plan_host.cpp`` with g++ into ``build/`` and
walks every block, turn and stage of one launch of each design, replaying
its epilogues' and fix-ups' stores, at the flagship's VE and VM shapes, a
ragged one, one with fewer stages than parts, a one-tile one and one of
many latents, for the H100's 132 SMs and for 66 and 7 resident blocks,
asserting that

* every lower tile (i >= j) takes its whole reduction n in [0, N) once: its
  stages [0, S) once, as one unit or as the P parts of the last turn;
* the consumers walk the stages in the cursor's order (the loads', and
  the three-pass route's splitters');
* each of a split tile's P parts writes its own slot, once, in the
  tile's row-major layout, and reduces its own 1/P of the tile's
  float4s: every float4 by exactly one part, each element's P partials
  read from the tile's slots in part order, so in increasing n: a fixed
  order, the same in every launch, whatever the data;
* no block reads more than its share of a split tile's partials: P
  partials of at most ceil(V / P) of the tile's V = 4,096 float4s;
* every output of (Q, M, M) is stored once: a value where m1 >= m2, a
  zero above the diagonal (a diagonal tile's own, or a lower tile's
  mirror), by a tile's epilogue or by the fix-up of a split tile;
* the grid never holds more blocks than the card keeps resident (132 on
  the H100, and fewer, as where clusters or another kernel hold SMs), so
  the split tiles' waits end, and the slots fit the flags (MAX_SLOTS);
* the thread, partial and splitter maps are each one to one, and the
  three-pass consumers' A-fragment loads read every float of a stage
  once, a warp's 32 loads of one element in 32 banks;
* the schedule's balance (the mean block's stages over the busiest
  block's, on 132 SMs) is at least 0.9 at the VE and VM shapes, where a
  grid of one tile a block would give 144 tiles on 132 SMs (0.545).

It skips, with the reason, where no g++ is found.  The card runs the
kernel itself against its plain versions and float64
(``chip_smoke.py``, ``tril_out_phase``).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import pytest

from hetmogp_tpu_torch.ops import _build

HOST_SOURCES = (_build.CSRC / "tril_out_plan_host.cpp",
                _build.CSRC / "tril_out_plan.cuh")
STATS = ("tile_faults", "order_faults", "split_faults", "map_faults",
         "write_faults", "blocks", "whole_turns", "last_tiles", "parts",
         "busiest", "total", "fixup_faults", "most_reads", "slots")
BT = 128  # a tile's rows and columns
BK = {0: 32, 1: 32}  # a stage's depth: FFMA, three-pass
TILE_VEC = BT * BT // 4  # a tile's float4s
MAX_SLOTS = 1024  # tril_out_plan.cuh: the flags
SHAPES = {"VE": (4, 3072, 1024), "VM": (4, 768, 1024),
          "ragged": (3, 1000, 772), "few stages": (4, 40, 1024),
          "one tile": (1, 100, 128), "many latents": (40, 300, 512)}


@pytest.fixture(scope="module")
def walk():
    """``csrc/tril_out_plan_host.cpp`` built with g++ into ``build/``
    (the name carries a hash of the sources) and loaded."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on PATH: the host build of kernel 8's plan "
                    "(csrc/tril_out_plan_host.cpp) needs a C++17 compiler")
    h = hashlib.sha256()
    for src in HOST_SOURCES:
        h.update(src.read_bytes())
    out = _build.BUILD_DIR / f"libtril_out_plan-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o",
                        str(tmp), str(HOST_SOURCES[0])], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.tril_out_plan_walk.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tril_out_plan_walk.restype = ctypes.c_longlong
    assert lib.tril_out_plan_stats() == len(STATS)

    def run(Q, N, M, three, sms):
        stats = (ctypes.c_longlong * len(STATS))()
        faults = lib.tril_out_plan_walk(Q, N, M, three, sms, stats)
        return faults, dict(zip(STATS, stats))

    return run


@pytest.mark.parametrize("three", [0, 1], ids=["f32", "3pass"])
@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_every_lower_tile_once_and_every_output_stored_once(walk, shape, sms,
                                                            three):
    Q, N, M = SHAPES[shape]
    faults, st = walk(Q, N, M, three, sms)
    assert faults == 0, st
    C = -(-M // BT)
    S = -(-N // BK[three])
    tiles = Q * C * (C + 1) // 2
    assert st["blocks"] == min(sms, tiles)
    # every lower tile's stages once: the total is the tiles' reductions
    assert st["total"] == tiles * S
    assert st["whole_turns"] * st["blocks"] + st["last_tiles"] == tiles
    assert 1 <= st["parts"] <= max(1, min(st["blocks"], S))


def test_split_parts_meet_in_a_fixed_order(walk):
    """At the flagship's VE and VM shapes the last turn's 12 tiles are each
    cut into 11 parts, one a block; where the tiles fill the turns, or a
    tile has fewer stages than there are blocks for it, the parts follow."""
    for three in (0, 1):
        for shape in ("VE", "VM"):
            _, st = walk(*SHAPES[shape], three, 132)
            assert (st["blocks"], st["whole_turns"], st["last_tiles"],
                    st["parts"]) == (132, 1, 12, 11), (shape, three, st)
        _, st = walk(*SHAPES["few stages"], three, 132)
        assert st["parts"] == -(-40 // BK[three])
        _, st = walk(*SHAPES["one tile"], three, 132)
        assert (st["blocks"], st["last_tiles"]) == (1, 0)


@pytest.mark.parametrize("three", [0, 1], ids=["f32", "3pass"])
@pytest.mark.parametrize("shape", ["VE", "VM"])
def test_schedule_balance_on_132_sms(walk, shape, three):
    """The mean block's stages over the busiest block's, on 132 SMs: at
    least 0.9 where one tile a block would give 0.545 (144 tiles on 132
    SMs)."""
    _, st = walk(*SHAPES[shape], three, 132)
    assert st["total"] / 132 / st["busiest"] >= 0.9


@pytest.mark.parametrize("three", [0, 1], ids=["f32", "3pass"])
@pytest.mark.parametrize("sms", [132, 66, 7])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_tiles_meet_in_part_order_each_part_its_share(walk, shape, sms,
                                                           three):
    """Every part of a split tile writes one slot and reduces 1/P of the
    tile from all P slots in part order; no block reads more than P
    partials of ceil(V / P) float4s; the slots, one a part, fit the
    flags."""
    faults, st = walk(*SHAPES[shape], three, sms)
    assert faults == 0 and st["fixup_faults"] == 0, st
    P = st["parts"]
    if P > 1:
        assert st["slots"] == st["last_tiles"] * P <= MAX_SLOTS
        assert st["most_reads"] <= P * -(-TILE_VEC // P)
    else:
        assert st["slots"] == 0 and st["most_reads"] == 0


@pytest.mark.parametrize("three", [0, 1], ids=["f32", "3pass"])
@pytest.mark.parametrize("resident", [132, 66, 7])
@pytest.mark.parametrize("shape", ["VE", "VM", "many latents"])
def test_grid_stays_within_the_resident_blocks(walk, shape, resident, three):
    """The split tiles' parts wait for each other, which ends only if every
    block of the grid is resident at once: G never exceeds the resident
    blocks the plan is given (the H100's 132 SMs, or fewer), and every
    output is still stored once."""
    faults, st = walk(*SHAPES[shape], three, resident)
    assert faults == 0, st
    Q, N, M = SHAPES[shape]
    C = -(-M // BT)
    assert st["blocks"] == min(resident, Q * C * (C + 1) // 2)

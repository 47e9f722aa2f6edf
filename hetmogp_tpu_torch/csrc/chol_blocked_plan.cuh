// Kernel 10's schedule (chol_blocked_kernel.cu): the tile tasks of the
// blocked Cholesky factor and inverse of a (B, M, M) stack, their order
// (the ticket's), what each waits for and what it publishes.  Plain C++
// behind K10_HD, which is __host__ __device__ under nvcc and empty under a
// host compiler, so that the CPU tests walk every task of a launch with
// the functions the kernel calls (chol_blocked_plan_host.cpp,
// tests/test_torch_chol_blocked_plan.py).  No CUDA header is included here.
//
// A matrix of nt x nt tiles of TILE (M = nt TILE: the wrapper pads a
// ragged M with an identity block).  Its tasks:
//   POTRF(k)     L_kk, iL_kk = kernel 9's panel routine of the updated
//                diagonal tile;
//   TRSM(i, k)   L_ik = acc tril(iL_kk)^T, refined once against L_kk
//                (i > k; acc the input tile for k = 0, else the tile its
//                last update rounded to float32);
//   UPD(i, k, j) C_ik -= L_ij L_kj^T in float64 (j < k <= i), the tile's
//                updates chained in panel order j = 0, 1, ..., rounded to
//                float32 once, by the last (j = k - 1);
//   ACC(i, j, k) X_ij += L_ik iL_kj, the terms of iL's tile (i, j) in
//                ascending k = j .. i - 2 (X_ij kept in iL's tile);
//   INV(i, j)    X_ij += L_i,i-1 iL_i-1,j, then iL_ij = -iL_ii X_ij
//                (j < i).
// Every TRSM and UPD is cut by rows (each row of either is computed from
// the same row of its operands alone) into row parts, so that a tile
// row's chain, TRSM(i, k) -> UPD(i, k + 1, k) -> TRSM(i, k + 1), and the
// chain between two POTRFs, run on several blocks at once: PARTS parts of
// TILE / PARTS rows for the tasks of the tile rows p + 1 and p + 2 next
// to panel p (what the next two POTRFs wait for), BULK parts for the
// others (fewer parts restage B less).  POTRF, ACC and INV take their
// whole tile.
//
// Each tile has a counter of the row parts written to it, UNITS (=
// PARTS) a whole tile: L's (i, k) counts its updates, then its POTRF or
// TRSM (final at UNITS (k + 1)); iL's (i, j), j < i, counts its ACC
// terms, then its INV (final at UNITS (i - j)); iL's (k, k) is final with
// L's (k, k).  A task waits until each tile it reads is final and its own
// tile has every earlier write, then adds its rows' units to its own
// tile's counter.
//
// The order: every task has a key, a wavefront over the panels,
//   POTRF(k) 6 k;  TRSM(i, k) 4 k + 2 i + 1;  UPD(i, k, j) 2 (j + i + k)
//   + 1;  ACC(i, j, k) 4 k + 2 i + 9;  INV(i, j) 6 i + 5,
// so that a panel's POTRF and the tile rows next to it come before the
// farther rows of the panels before it, and the inverse's tiles follow
// the factor's by about a panel (a linear fit of the latest start times
// of the DAG's critical-path schedule; at B = 8, M = 1024 it leaves the
// latest-start order's simulated time 2% behind, where a phase-by-phase
// order left it 21% behind).  Each task's key is above every one of its
// dependencies', so tasks of one key never wait on each other and the
// order of a key's tasks is free: the tickets take a matrix's tasks key
// by key, the B matrices' each task in turn.  Every task waits only on
// tasks of earlier tickets, so the persistent blocks, taking tickets in
// order, cannot deadlock (the test walks it).

#pragma once

#if defined(__CUDACC__)
#define K10_HD __host__ __device__ __forceinline__
#else
#define K10_HD inline
#endif

namespace chol_blocked_plan {

constexpr int TILE = 128;  // a tile's rows and columns: kernel 9's widest
constexpr int PARTS = 4;    // row parts of a TRSM or UPD next to a panel
constexpr int BULK = 2;     // row parts of the other TRSMs and UPDs
constexpr int UNITS = PARTS;  // a whole tile on a counter
constexpr int MAX_DEPS = 4;

enum Kind { POTRF = 0, TRSM = 1, UPD = 2, ACC = 3, INV = 4, NONE = 5 };

// POTRF: i = k (the diagonal tile); TRSM: (i, k); UPD: (i, k, j);
// ACC: iL's tile (i, j), term k; INV: iL's tile (i, j).  Rows part *
// TILE / parts .. of its tile (parts 1 or PARTS).
struct Task {
  int kind, b, i, k, j, part, parts;
};

struct Dep {
  int flag, target;  // wait until flags[flag] >= target
};

K10_HD Task make(int kind, int i, int k, int j) {
  Task t;
  t.kind = kind;
  t.b = 0;
  t.i = i;
  t.k = k;
  t.j = j;
  t.part = 0;
  t.parts = 1;
  return t;
}

K10_HD Task in_parts(Task t, int part, int parts = PARTS) {
  t.part = part;
  t.parts = parts;
  return t;
}

// Row parts: PARTS for a TRSM or UPD in the tile rows next to its panel
// (i - panel <= 2), BULK for the others.
K10_HD int trsm_parts(int i, int k) { return i - k <= 2 ? PARTS : BULK; }
K10_HD int upd_parts(int i, int j) { return i - j <= 2 ? PARTS : BULK; }

// Tasks of one matrix: nt POTRF, nt (nt - 1) / 2 INV, C(nt, 3) ACC, and
// the nt (nt - 1) / 2 TRSM and C(nt + 1, 3) UPD in parts: PARTS each for
// the 2 nt - 3 TRSM and 3 nt - 5 UPD next to a panel, BULK for the rest.
K10_HD long long tasks_per_matrix(int nt) {
  const long long n = nt;
  const long long near = n >= 2 ? 5 * n - 8 : 0;
  const long long split = n * (n - 1) / 2 + (n + 1) * n * (n - 1) / 6;
  return n + n * (n - 1) / 2 + n * (n - 1) * (n - 2) / 6 +
         PARTS * near + BULK * (split - near);
}

K10_HD long long total_tasks(int batch, int nt) {
  return (long long)batch * tasks_per_matrix(nt);
}

// The keys lie in [0, KEYS(nt)).
K10_HD int keys(int nt) { return 6 * nt; }

// The tasks of one matrix whose key is `key`, in the order POTRF; TRSM by
// panel; UPD by panel, then column; ACC by term, then column; INV by
// column; a task's parts in turn.  With want < 0: how many.  Else the
// want-th into *out (returns -1), or, past them, how many.
K10_HD long long key_tasks(int key, int nt, long long want, Task* out) {
  long long n = 0;
  auto take = [&](long long c) {  // c tasks of a group; true: found
    if (want >= 0 && want < n + c) return true;
    n += c;
    return false;
  };
  if (key % 2 == 0) {  // POTRF(k): 6 k
    if (key % 6 == 0 && key / 6 < nt && take(1)) {
      *out = make(POTRF, key / 6, key / 6, -1);
      return -1;
    }
    return n;
  }
  const int h = (key - 1) / 2;
  // TRSM(i, k): 4 k + 2 i + 1, i = h - 2 k, k < i < nt
  for (int k = 0; 3 * k < h; ++k) {
    const int i = h - 2 * k;
    if (i >= nt) continue;
    const int parts = trsm_parts(i, k);
    if (take(parts)) {
      *out = in_parts(make(TRSM, i, k, -1), (int)(want - n), parts);
      return -1;
    }
  }
  // UPD(i, k, j): 2 (j + i + k) + 1, j < k <= i < nt, i + k = h - j
  for (int j = 0; j < nt; ++j) {
    const int sum = h - j;
    int lo = j + 1, hi = sum / 2;  // k, with i = sum - k >= k
    if (sum - (nt - 1) > lo) lo = sum - (nt - 1);
    if (hi < lo) continue;
    // k >= sum - j - 2: i - j <= 2, the parts near the panel
    const int near_lo = sum - j - 2 > lo ? sum - j - 2 : lo;
    const long long near = hi >= near_lo ? hi - near_lo + 1 : 0;
    if (!take(BULK * (hi - lo + 1 - near) + PARTS * near)) continue;
    long long rest = want - n;
    for (int k = lo; k <= hi; ++k) {
      const int parts = upd_parts(sum - k, j);
      if (rest < parts) {
        *out = in_parts(make(UPD, sum - k, k, j), (int)rest, parts);
        return -1;
      }
      rest -= parts;
    }
  }
  // ACC(i, j, k): 4 k + 2 i + 9, i = (key - 9) / 2 - 2 k, j <= k <= i - 2
  if (key >= 9) {
    const int g = (key - 9) / 2;
    for (int k = 0; 3 * k + 2 <= g; ++k) {
      const int i = g - 2 * k;
      if (i >= nt) continue;
      if (take(k + 1)) {
        *out = make(ACC, i, k, (int)(want - n));
        return -1;
      }
    }
  }
  // INV(i, j): 6 i + 5, j < i
  if ((key - 5) % 6 == 0) {
    const int i = (key - 5) / 6;
    if (i >= 1 && i < nt && take(i)) {
      *out = make(INV, i, -1, (int)(want - n));
      return -1;
    }
  }
  return n;
}

// The tickets in order: a matrix's tasks by key (a wavefront over the
// panels), the B matrices' each task in turn (ticket = sequence index *
// B + b).  A block's tickets only grow, so its Cursor walks the keys
// forward once over the launch.
struct Cursor {
  int key;
  long long start, count;  // tasks of the keys before `key`, and of `key`
  int nt;
  K10_HD explicit Cursor(int nt_) : key(0), start(0), nt(nt_) {
    count = key_tasks(0, nt, -1, nullptr);
  }
  // the task of ticket t (at least the last one asked for)
  K10_HD Task at(long long t, int batch) {
    const long long seq = t / batch;
    while (seq >= start + count && key < keys(nt)) {
      start += count;
      ++key;
      count = key < keys(nt) ? key_tasks(key, nt, -1, nullptr) : 0;
    }
    Task task = make(NONE, -1, -1, -1);
    if (seq < start + count) key_tasks(key, nt, seq - start, &task);
    task.b = (int)(t % batch);
    return task;
  }
};

// Ticket t of a launch over `batch` matrices.
K10_HD Task task_at(long long t, int batch, int nt) {
  Cursor c(nt);
  return c.at(t, batch);
}

// The counters: L's tiles, then iL's below the diagonal, then the ticket.
K10_HD int l_flag(int b, int nt, int i, int k) { return (b * nt + i) * nt + k; }
K10_HD int x_flag(int batch, int b, int nt, int i, int j) {
  return batch * nt * nt + (b * nt + i) * nt + j;
}
K10_HD int ticket_flag(int batch, int nt) { return 2 * batch * nt * nt; }
K10_HD int n_flags(int batch, int nt) { return 2 * batch * nt * nt + 1; }

// What the task waits for (returns how many of deps[MAX_DEPS]); the last
// is always its own tile with every earlier write.  Targets in writes of
// whole tiles (UNITS on the counters).
K10_HD int deps_of(const Task& t, int batch, int nt, Dep* deps) {
  const int b = t.b;
  int n = 0;
  auto L = [&](int i, int k, int target) {
    deps[n].flag = l_flag(b, nt, i, k);
    deps[n].target = UNITS * target;
    ++n;
  };
  auto X = [&](int i, int j, int target) {
    deps[n].flag = x_flag(batch, b, nt, i, j);
    deps[n].target = UNITS * target;
    ++n;
  };
  switch (t.kind) {
    case POTRF:
      L(t.k, t.k, t.k);
      break;
    case TRSM:
      L(t.k, t.k, t.k + 1);
      L(t.i, t.k, t.k);
      break;
    case UPD:
      L(t.i, t.j, t.j + 1);
      if (t.k != t.i) L(t.k, t.j, t.j + 1);
      L(t.i, t.k, t.j);
      break;
    case ACC:
      L(t.i, t.k, t.k + 1);
      if (t.k == t.j) {
        L(t.j, t.j, t.j + 1);
      } else {
        X(t.k, t.j, t.k - t.j);
      }
      X(t.i, t.j, t.k - t.j);
      break;
    case INV:
      L(t.i, t.i - 1, t.i);
      L(t.i, t.i, t.i + 1);
      if (t.j == t.i - 1) {
        L(t.j, t.j, t.j + 1);
      } else {
        X(t.i - 1, t.j, t.i - 1 - t.j);
      }
      X(t.i, t.j, t.i - 1 - t.j);
      break;
    default:
      break;
  }
  return n;
}

// What the task adds to its own tile's counter: its rows' units.
K10_HD int units_of(const Task& t) { return UNITS / t.parts; }

// The counter the task adds to: its own tile's.
K10_HD int flag_of(const Task& t, int batch, int nt) {
  switch (t.kind) {
    case POTRF:
      return l_flag(t.b, nt, t.k, t.k);
    case TRSM:
    case UPD:
      return l_flag(t.b, nt, t.i, t.k);
    default:
      return x_flag(batch, t.b, nt, t.i, t.j);
  }
}

}  // namespace chol_blocked_plan

// The host build of kernel 10's schedule (chol_blocked_plan.cuh), for the
// CPU tests: walks every ticket of one launch in order with the functions
// the kernel calls, as one block taking every ticket would, and checks
// the schedule without running the kernel; and lists the tasks, their
// waits and their counters, for a plain executor of the plan.
// tests/test_torch_chol_blocked_plan.py loads it with ctypes after
// compiling it with a host C++ compiler:
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libplan.so chol_blocked_plan_host.cpp
//
// The CUDA build (ops/_build.py) compiles the *.cu sources only.

#include <stdint.h>

#include <algorithm>
#include <vector>

#include "chol_blocked_plan.cuh"

using namespace chol_blocked_plan;

// What the walk counts (`stats`, in this order).
enum Stat {
  TASKS,          // tickets below the launch's total
  KIND_0,         // of them POTRF, TRSM, UPD, ACC, INV
  WAIT_FAULTS = KIND_0 + 5,  // waits on a counter that no earlier ticket
                             // brought to its target
  CHAIN_FAULTS,   // tasks whose own tile had another number of earlier
                  // writes than their last wait names (a part: or than
                  // its stage's other parts, which write other rows), or
                  // whose last wait is not their own tile's counter, or
                  // parts whose rows are not a part of the tile's
  OUTPUT_FAULTS,  // tiles of L or iL written final other than once (in
                  // row parts: other than UNITS units)
  FINAL_FAULTS,   // counters that end other than at their tile's final
                  // count, or a ticket at or past the total that is a task
  N_STATS
};

extern "C" long long chol_blocked_plan_walk(int batch, int nt,
                                            long long* stats) {
  std::fill(stats, stats + N_STATS, 0LL);
  const long long total = total_tasks(batch, nt);
  std::vector<int> flags(n_flags(batch, nt), 0);
  // final writes of L's and iL's tiles
  std::vector<int> l_out((size_t)batch * nt * nt, 0),
      i_out((size_t)batch * nt * nt, 0);
  auto tile = [&](int b, int i, int k) { return ((size_t)b * nt + i) * nt + k; };
  Cursor cursor(nt);
  for (long long t = 0; t < total; ++t) {
    const Task task = cursor.at(t, batch);
    ++stats[TASKS];
    if (task.kind < 0 || task.kind >= NONE) {
      ++stats[FINAL_FAULTS];
      continue;
    }
    ++stats[KIND_0 + task.kind];
    Dep deps[MAX_DEPS];
    const int n = deps_of(task, batch, nt, deps);
    for (int d = 0; d < n; ++d) {
      stats[WAIT_FAULTS] += flags[deps[d].flag] < deps[d].target;
    }
    const int own = flag_of(task, batch, nt);
    const int units = units_of(task);
    // a part runs beside its stage's other parts: its tile has the
    // stage's target, and at most the other parts' units, written
    const int ahead = n < 1 ? -1 : flags[own] - deps[n - 1].target;
    stats[CHAIN_FAULTS] +=
        n < 1 || deps[n - 1].flag != own || ahead < 0 ||
        ahead > UNITS - units || ahead % units != 0 ||
        task.part < 0 || task.part >= task.parts ||
        (task.kind == TRSM || task.kind == UPD
             ? task.parts != PARTS && task.parts != BULK
             : task.parts != 1);
    flags[own] += units;
    const int b = task.b;
    switch (task.kind) {
      case POTRF:
        l_out[tile(b, task.k, task.k)] += UNITS;
        i_out[tile(b, task.k, task.k)] += UNITS;
        break;
      case TRSM:
        l_out[tile(b, task.i, task.k)] += units;
        l_out[tile(b, task.k, task.i)] += units;
        i_out[tile(b, task.k, task.i)] += units;
        break;
      case INV:
        i_out[tile(b, task.i, task.j)] += UNITS;
        break;
      default:
        break;
    }
  }
  for (int b = 0; b < batch; ++b) {
    for (int i = 0; i < nt; ++i) {
      for (int k = 0; k < nt; ++k) {
        stats[OUTPUT_FAULTS] += l_out[tile(b, i, k)] != UNITS;
        stats[OUTPUT_FAULTS] += i_out[tile(b, i, k)] != UNITS;
        if (k <= i) {
          stats[FINAL_FAULTS] += flags[l_flag(b, nt, i, k)] != UNITS * (k + 1);
        }
        if (k < i) {
          stats[FINAL_FAULTS] +=
              flags[x_flag(batch, b, nt, i, k)] != UNITS * (i - k);
        }
      }
    }
  }
  stats[FINAL_FAULTS] += flags[ticket_flag(batch, nt)] != 0;
  stats[FINAL_FAULTS] += task_at(total, batch, nt).kind != NONE;
  return stats[WAIT_FAULTS] + stats[CHAIN_FAULTS] + stats[OUTPUT_FAULTS] +
         stats[FINAL_FAULTS];
}

extern "C" int chol_blocked_plan_stats() { return N_STATS; }

// Each ticket's task as TASK_INTS ints: kind, b, i, k, j, its own counter,
// its waits' count, MAX_DEPS (counter, target) pairs, its part, its parts
// and the units it adds.
constexpr int TASK_INTS = 10 + 2 * MAX_DEPS;

extern "C" int chol_blocked_plan_task_ints() { return TASK_INTS; }

extern "C" long long chol_blocked_plan_tasks(int batch, int nt, int* out) {
  const long long total = total_tasks(batch, nt);
  Cursor cursor(nt);
  for (long long t = 0; t < total; ++t) {
    const Task task = cursor.at(t, batch);
    int* o = out + t * TASK_INTS;
    std::fill(o, o + TASK_INTS, -1);
    o[0] = task.kind;
    o[1] = task.b;
    o[2] = task.i;
    o[3] = task.k;
    o[4] = task.j;
    o[5] = flag_of(task, batch, nt);
    Dep deps[MAX_DEPS];
    o[6] = deps_of(task, batch, nt, deps);
    for (int d = 0; d < o[6]; ++d) {
      o[7 + 2 * d] = deps[d].flag;
      o[8 + 2 * d] = deps[d].target;
    }
    o[7 + 2 * MAX_DEPS] = task.part;
    o[8 + 2 * MAX_DEPS] = task.parts;
    o[9 + 2 * MAX_DEPS] = units_of(task);
  }
  return total;
}

extern "C" int chol_blocked_plan_flags(int batch, int nt) {
  return n_flags(batch, nt);
}

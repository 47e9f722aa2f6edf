"""Host-side data pipeline: the minibatch stream, batch scales, the
whole-dataset batch, inducing-point initialization, the toy generators and
the table loader.

Counterpart of ``hetmogp_tpu/data.py``.  The stream draws from numpy's
``RandomState(seed)`` exactly as the JAX one does, so the two packages see
the same index stream from the same seed; ``init_z_kmeans``,
``true_u_functions``, ``generate_toy_U``, ``true_f_functions`` and
``load_spatial_table`` are the JAX package's numpy code, so they give the
same arrays from the same seed and file.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hetmogp_tpu_torch.models.elbo import TaskData, task_data


def batch_scales(X_all: Sequence, X_batch: Sequence,
                 masks: Optional[Sequence] = None) -> List[float]:
    """N_full / N_batch per task.

    masks: optional per-task 0/1 row masks of padded batches: padding rows
    do not count toward N_batch.
    """
    if masks is None:
        return [float(len(xa)) / float(len(xb))
                for xa, xb in zip(X_all, X_batch)]
    return [float(len(xa)) / float(np.sum(np.asarray(m)))
            for xa, m in zip(X_all, masks)]


class MinibatchStream:
    """Infinite fixed-shape minibatch stream over a heterogeneous dataset.

    Args:
      X_list, Y_list: per-task full data (numpy arrays).
      batch_sizes: per-task batch size, or one int for all tasks.  A task
        smaller than its batch size is included whole each step.
      shuffle: permute per epoch; False cycles sequentially (the
        reference's behaviour).
      seed: numpy ``RandomState`` seed of the permutations.
      pad_multiple: round every batch's row count up to a multiple of this;
        padded rows have mask 0.
      dtype: the tensors' dtype (None keeps the arrays').
      device: where ``next()`` puts the batches; the card unless the
        caller names another.
    """

    def __init__(self, X_list: Sequence, Y_list: Sequence,
                 batch_sizes, *, shuffle: bool = True, seed: int = 0,
                 pad_multiple: int = 1, dtype=None, device="cuda"):
        self.X_list = [np.asarray(x) for x in X_list]
        # a 1-D Y is one observation column
        self.Y_list = [np.asarray(y)[:, None] if np.asarray(y).ndim == 1
                       else np.asarray(y) for y in Y_list]
        T = len(self.X_list)
        if isinstance(batch_sizes, int):
            batch_sizes = [batch_sizes] * T
        self.batch_sizes = [min(b, len(x))
                            for b, x in zip(batch_sizes, self.X_list)]
        self.padded_sizes = [-(-b // pad_multiple) * pad_multiple
                             for b in self.batch_sizes]
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.dtype, self.device = dtype, device
        self._order = [np.arange(len(x)) for x in self.X_list]
        self._pos = [0] * T
        if shuffle:
            for t in range(T):
                self.rng.shuffle(self._order[t])

    def _next_indices(self, t: int) -> np.ndarray:
        n = len(self._order[t])
        start = self._pos[t]
        stop = min(start + self.batch_sizes[t], n)
        # a copy: the end-of-epoch reshuffle below permutes the order in place
        idx = self._order[t][start:stop].copy()
        self._pos[t] = stop
        if stop >= n:
            self._pos[t] = 0
            if self.shuffle:
                self.rng.shuffle(self._order[t])
        return idx

    def next(self) -> Tuple[Tuple[TaskData, ...], np.ndarray]:
        """One step's batches: (per-task TaskData, scales (T,))."""
        batches, scales = [], []
        for t in range(len(self.X_list)):
            idx = self._next_indices(t)
            n_real, n_pad = len(idx), self.padded_sizes[t]
            if n_real < n_pad:  # wraparound fill, masked out
                idx_full = np.concatenate(
                    [idx, np.resize(self._order[t], n_pad - n_real)])
            else:
                idx_full = idx
            mask = np.zeros(n_pad)
            mask[:n_real] = 1.0
            batches.append(task_data(self.X_list[t][idx_full],
                                     self.Y_list[t][idx_full], mask,
                                     dtype=self.dtype, device=self.device))
            # the scale uses the batch's real row count
            scales.append(len(self.X_list[t]) / float(n_real))
        return tuple(batches), np.asarray(scales)

    def __iter__(self):
        while True:
            yield self.next()


def full_batch(X_list, Y_list, dtype=None, pad_multiple: int = 1,
               device="cuda") -> Tuple[Tuple[TaskData, ...], np.ndarray]:
    """The whole dataset as one static batch, scales = 1.

    Each task's rows are padded up to a multiple of ``pad_multiple`` by
    repeating its first row with mask 0, as the JAX ``full_batch`` does.
    The tensors go to ``device``: the card unless the caller names another.
    """
    batches = []
    for x, y in zip(X_list, Y_list):
        x, y = np.asarray(x), np.asarray(y)
        if y.ndim == 1:
            y = y[:, None]
        n = x.shape[0]
        n_pad = -(-n // pad_multiple) * pad_multiple
        mask = np.zeros(n_pad)
        mask[:n] = 1.0
        if n_pad > n:
            pad_idx = np.concatenate([np.arange(n),
                                      np.zeros(n_pad - n, dtype=int)])
            x, y = x[pad_idx], y[pad_idx]
        batches.append(task_data(x, y, mask, dtype=dtype, device=device))
    return tuple(batches), np.ones(len(batches))


def init_z_kmeans(X_list: Sequence, num_inducing: int, seed: int = 0,
                  iters: int = 25) -> np.ndarray:
    """K-means inducing-point initialization over the pooled task inputs.

    The reference imports GPy's ``kmm_init`` but leaves it commented out
    (svmogp.py:50); provided here as a working initializer.  Lloyd's
    algorithm on a subsample; returns (M, Dx).
    """
    X = np.concatenate([np.asarray(x) for x in X_list], axis=0)
    rng = np.random.RandomState(seed)
    if X.shape[0] > 50_000:
        X = X[rng.choice(X.shape[0], 50_000, replace=False)]
    M = min(num_inducing, X.shape[0])
    centers = X[rng.choice(X.shape[0], M, replace=False)].copy()
    for _ in range(iters):
        d2 = ((X[:, None, :] - centers[None, :, :]) ** 2).sum(-1) \
            if X.shape[0] * M * X.shape[1] < 5e7 else None
        if d2 is None:
            # chunked distance computation for big pools
            assign = np.empty(X.shape[0], dtype=np.int64)
            for s in range(0, X.shape[0], 8192):
                blk = X[s:s + 8192]
                assign[s:s + 8192] = np.argmin(
                    ((blk[:, None, :] - centers[None, :, :]) ** 2).sum(-1), 1)
        else:
            assign = np.argmin(d2, axis=1)
        for m in range(M):
            pts = X[assign == m]
            if len(pts):
                centers[m] = pts.mean(axis=0)
    return centers


# ---------------------------------------------------------------------------
# synthetic data (reference util.py:21-50, 202-206)
# ---------------------------------------------------------------------------

def true_u_functions(X_list: Sequence, Q: int, seed: int = 0):
    """Random sinusoid-mixture latent functions (reference util.py:21-34)."""
    rng = np.random.RandomState(seed)
    amplitude = (1.5 - 0.5) * rng.rand(Q, 3) + 0.5
    freq = (3 - 1) * rng.rand(Q, 3) + 1
    shift = 2 * rng.rand(Q, 3)
    out = []
    for X in X_list:
        X = np.asarray(X)
        u_task = np.empty((X.shape[0], Q))
        for q in range(Q):
            u_task[:, q] = (
                3 * amplitude[q, 0] * np.cos(freq[q, 0] * np.pi * X[:, 0] + shift[q, 0] * np.pi)
                - 2 * amplitude[q, 1] * np.sin(2 * freq[q, 1] * np.pi * X[:, 0] + shift[q, 1] * np.pi)
                + amplitude[q, 2] * np.cos(4 * freq[q, 2] * np.pi * X[:, 0] + shift[q, 2] * np.pi))
        out.append(u_task)
    return out


def generate_toy_U(X, Q: int, seed=None) -> np.ndarray:
    """Random sin+cos latent draws, one column per latent (reference
    ``generate_toy_U``, util.py:202-206): U[:, q] = 2 r_q sin(10 r_q x + e1)
    + 2 r_q cos(20 r_q x + e2) with r ~ U(0,1) shared across rows and
    e1, e2 ~ N(0,1) shared across everything."""
    rng = np.random.RandomState(seed)
    X = np.asarray(X)
    arg = np.tile(X, (1, Q))
    rnd = np.tile(rng.rand(1, Q), (X.shape[0], X.shape[1]))
    return (2 * rnd * np.sin(10 * rnd * arg + rng.randn(1))
            + 2 * rnd * np.cos(20 * rnd * arg + rng.randn(1)))


def true_f_functions(true_u: Sequence, W: np.ndarray, function_index,
                     d_index) -> List[np.ndarray]:
    """Mix latent samples into per-task parameter functions F = u W
    (reference util.py:36-50).  W: (Q, D) over the global function axis."""
    T = int(np.max(function_index)) + 1
    out = []
    for t in range(T):
        u_task = np.asarray(true_u[t])
        dims = [d for d in range(len(function_index)) if function_index[d] == t]
        F = np.zeros((u_task.shape[0], len(dims)))
        for d in dims:
            F[:, int(np.ravel(d_index)[d])] = u_task @ W[:, d]
        out.append(F)
    return out


def load_spatial_table(path):
    """Ingestion hook for real spatial multi-task datasets.

    The reference's headline real-data example (London house prices,
    reference README.md:54-57) ships no dataset; this loader is the drop-in
    point for it — or any per-task tabular workload — the moment a file
    exists.  Two schemas:

    * **CSV** with a header row: input columns ``x1..x<Dx>`` (any count,
      detected from the header), a ``task`` column (0-based task index),
      and a ``y`` column.  One observation per row, e.g.::

          x1,x2,task,y
          0.12,0.84,0,12.37     # task 0: e.g. log-price (HetGaussian)
          0.55,0.31,1,2         # task 1: e.g. property type (Categorical)

    * **NPZ** with per-task arrays ``X0``, ``Y0``, ``X1``, ``Y1``, ... —
      ``X<t>`` is (N_t, Dx) and ``Y<t>`` is (N_t,) or (N_t, dim_y)
      (multi-column observations, e.g. Dirichlet proportions, need NPZ).

    Returns ``(X_list, Y_list)`` ordered by task index, each Y shaped
    (N_t, dim_y).  Tasks may have different sizes (ragged).
    """
    from pathlib import Path

    p = Path(path)
    if p.suffix.lower() == ".npz":
        with np.load(p, allow_pickle=False) as z:
            tasks = sorted(int(k[1:]) for k in z.files if k.startswith("X")
                           and k[1:].isdigit())
            if not tasks or tasks != list(range(len(tasks))):
                raise ValueError(
                    f"{p}: NPZ schema needs contiguous X0/Y0, X1/Y1, ... "
                    f"keys; found {sorted(z.files)}")
            X_list, Y_list = [], []
            for t in tasks:
                if f"Y{t}" not in z.files:
                    raise ValueError(f"{p}: X{t} present but Y{t} missing")
                X = np.asarray(z[f"X{t}"], dtype=np.float64)
                Y = np.asarray(z[f"Y{t}"], dtype=np.float64)
                if Y.ndim == 1:
                    Y = Y[:, None]
                if X.ndim != 2 or X.shape[0] != Y.shape[0]:
                    raise ValueError(
                        f"{p}: X{t} {X.shape} / Y{t} {Y.shape} row mismatch")
                X_list.append(X)
                Y_list.append(Y)
            return X_list, Y_list

    # CSV schema
    tab = np.genfromtxt(p, delimiter=",", names=True, dtype=np.float64)
    names = list(tab.dtype.names or ())
    x_cols = sorted((n for n in names if n.startswith("x")
                     and n[1:].isdigit()), key=lambda n: int(n[1:]))
    if not x_cols or "task" not in names or "y" not in names:
        raise ValueError(
            f"{p}: CSV schema needs header columns x1..x<Dx>, task, y; "
            f"got {names}")
    X = np.stack([np.atleast_1d(tab[c]) for c in x_cols], axis=1)
    task = np.atleast_1d(tab["task"]).astype(int)
    y = np.atleast_1d(tab["y"])
    n_tasks = int(task.max()) + 1
    X_list, Y_list = [], []
    for t in range(n_tasks):
        sel = task == t
        if not np.any(sel):
            raise ValueError(f"{p}: no rows for task {t} (tasks must be "
                             "contiguous 0-based indices)")
        X_list.append(X[sel])
        Y_list.append(y[sel][:, None])
    return X_list, Y_list

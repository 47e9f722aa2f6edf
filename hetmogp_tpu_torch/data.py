"""Host-side data pipeline: the minibatch stream, batch scales and the
whole-dataset batch.

Counterpart of ``batch_scales``, ``MinibatchStream`` and ``full_batch`` in
``hetmogp_tpu/data.py``.  The stream draws from numpy's
``RandomState(seed)`` exactly as the JAX one does, so the two packages see
the same index stream from the same seed.  The toy generators and loaders
there are not ported (ROADMAP.md section 1, item 13).
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

"""Dataset assembly for the on-device trainer.

Counterpart of ``full_batch`` in ``hetmogp_tpu/data.py``; the minibatch
streams and the toy generators there are not ported (ROADMAP.md section 1,
item 13).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hetmogp_tpu_torch.models.elbo import TaskData, task_data


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

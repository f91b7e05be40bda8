"""Linear sum assignment (Hungarian matching) on the host.

Counterpart of dpft_tpu/ops/hungarian.py:assign, with the same contract.
The JAX package solves on the device because a TPU program cannot leave
the chip cheaply; here the cost matrices of the whole batch cross to the
host in one copy (B x M x (N + M) floats, about 220 KB at the flagship
shapes) and the C++ shortest-augmenting-path solver of
dpft_tpu_torch/ops/lap_native.py (dpft_tpu_torch/csrc/lap.cc, built by g++
at first use) solves them. For a
problem with a unique optimum it gives the same assignment as the JAX
solver and as scipy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dpft_tpu_torch.ops import lap_native

_VIRT_COST = 1e9  # dominates any real matching cost


def assign(cost: torch.Tensor, row_mask: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DETR-style matching of queries to targets, batched.

    Arguments:
        cost: (B, N, M) cost of query n for target m, M <= N.
        row_mask: optional (B, M) bool, True for real targets. Padded
            targets go to virtual columns of their own and come back with
            the sentinel ``index_i == N``; the real targets get the optimum
            of the real subproblem.

    Returns:
        (index_i, index_j), each (B, M) int64 on the device of ``cost``:
        the query matched to target ``index_j[k]`` is ``index_i[k]``, and
        ``index_i`` is ascending (sentinels last).
    """
    B, N, M = cost.shape
    cost_tm = cost.detach().float().transpose(1, 2).cpu().numpy()  # (B, M, N)
    if row_mask is None:
        col4row = lap_native.solve_batch(cost_tm)
    else:
        real = row_mask.detach().cpu().numpy().astype(bool)       # (B, M)
        eye = np.eye(M, dtype=bool)[None]
        virt = np.where(eye & ~real[:, None, :], -_VIRT_COST, _VIRT_COST)
        aug = np.concatenate([cost_tm * real[:, :, None], virt], axis=2)
        col4row = lap_native.solve_batch(aug)
        col4row = np.where(col4row >= N, N, col4row)  # pads -> sentinel N
    order = np.argsort(col4row, axis=1, kind="stable")
    index_i = np.take_along_axis(col4row, order, axis=1)
    return (torch.from_numpy(index_i.astype(np.int64)).to(cost.device),
            torch.from_numpy(order.astype(np.int64)).to(cost.device))

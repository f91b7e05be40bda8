"""BatchNorm over the global batch of a data-parallel step.

Under pjit the JAX package's BatchNorm takes its statistics over the global
batch (dpft_tpu/parallel/mesh.py): XLA all-reduces them across devices.
``GlobalBatchNorm2d`` does the same across the data-parallel ranks (the
'data' sub-group of a (data, model) mesh), on the CPU (gloo) as on cards,
which ``nn.SyncBatchNorm`` cannot: it refuses CPU tensors.

The statistics are merged in one all-gather per layer. Each rank takes its
own count, mean and centered sum of squares per channel (two passes over
its rows, ``torch.var_mean``) as a (3, C) float64 block; the all-gather
gives every rank every rank's block, and each merges them the same way
(Chan et al.'s pairwise update: the centered sums plus each rank's count
times its mean's squared distance from the global mean). That is as
stable as a two-pass variance over the whole batch and costs one
collective instead of the two that an all-reduce of the mean, then of the
centered sum, would. The all-gather (``_AllGather``) carries the
gradient: its backward sums every rank's gradient of each block on the
rank that sent it, so the input gradient is the whole batch's. The normalization itself (``_Normalize``) subtracts the
mean first and keeps only the input for its backward, as native
BatchNorm does.

The ranks are those of the group given to :func:`convert_batchnorm` (the
world by default). In eval mode, and where that group has one rank or
none exists, the module is ``nn.BatchNorm2d`` itself. It keeps ``nn.BatchNorm2d``'s parameters,
buffers and state_dict keys, and updates ``running_var`` with the unbiased
variance of the global batch (the global count).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn


class _AllGather(torch.autograd.Function):
    """Every rank's block of ``group``, stacked in group-rank order. The
    backward gives each rank the sum, over ranks in that order, of every
    rank's gradient of its block (``torch.distributed.nn``'s all-gather
    does the same by a scatter that names the source by its rank in the
    world, which fails on a sub-group; an all-gather of the gradients
    works on any group)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        parts = [torch.empty_like(grad)
                 for _ in range(dist.get_world_size(ctx.group))]
        dist.all_gather(parts, grad, group=ctx.group)
        me = dist.get_rank(ctx.group)
        return torch.sum(torch.stack([g[me] for g in parts]), dim=0), None


class _Normalize(torch.autograd.Function):
    """``(x - mean) * invstd * weight + bias`` per channel, whose backward
    takes the sums over ``dy`` and ``dy * (x - mean)`` as native BatchNorm
    does, from ``x`` (the one full-size tensor it keeps): written as ``x *
    scale + shift``, autograd would form ``sum(dy * x) - mean * sum(dy)``,
    which loses float32's digits where a channel's mean is large against
    its spread."""

    @staticmethod
    def forward(ctx, x, mean, invstd, weight, bias):
        ctx.save_for_backward(x, mean, invstd, weight)
        scale = invstd * weight
        return (x - mean[:, None, None]) * scale[:, None, None] + \
            bias[:, None, None]

    @staticmethod
    def backward(ctx, dy):
        x, mean, invstd, weight = ctx.saved_tensors
        sum_dy = dy.sum((0, 2, 3))
        sum_dy_xmu = (dy * (x - mean[:, None, None])).sum((0, 2, 3))
        dx = dy * (invstd * weight)[:, None, None]
        return (dx, -sum_dy * invstd * weight, sum_dy_xmu * weight,
                sum_dy_xmu * invstd, sum_dy)


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode statistics are those of the
    global batch across the ranks of ``group`` (see the module
    docstring)."""

    group = None  # the process group; None is the world

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and dist.is_initialized() and
                dist.get_world_size(self.group) > 1):
            return super().forward(x)
        group = self.group
        self._check_input_dim(x)
        C = x.shape[1]
        dtype = torch.promote_types(x.dtype, torch.float32)
        xc = x.to(dtype)
        var, mean = torch.var_mean(xc, dim=(0, 2, 3), correction=0)
        # Merged in float64: counts beyond 2 ** 24 stay exact.
        count = x.new_full((C,), x.numel() // C, dtype=torch.float64)
        rows = torch.stack([count, mean.double(), var.double() * count])
        counts, means, m2 = _AllGather.apply(rows, group).unbind(1)
        n = counts.sum(0)
        mean64 = (counts * means).sum(0) / n
        var64 = (m2.sum(0) + (counts * (means - mean64) ** 2).sum(0)) / n

        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                momentum = (1.0 / float(self.num_batches_tracked)
                            if self.momentum is None else self.momentum)
                unbiased = var64 * (n / (n - 1).clamp_min(1.0))
                self.running_mean.lerp_(
                    mean64.to(self.running_mean.dtype), momentum)
                self.running_var.lerp_(unbiased.to(self.running_var.dtype),
                                       momentum)

        invstd = torch.rsqrt(var64 + self.eps).to(dtype)
        ones = torch.ones(C, dtype=dtype, device=x.device)
        weight = self.weight.to(dtype) if self.affine else ones
        bias = self.bias.to(dtype) if self.affine else ones * 0
        return _Normalize.apply(xc, mean64.to(dtype), invstd, weight,
                                bias).to(x.dtype)


def convert_batchnorm(module: nn.Module, group=None) -> nn.Module:
    """Makes every ``nn.BatchNorm2d`` under ``module`` (and ``module``
    itself, if it is one) a ``GlobalBatchNorm2d`` over the ranks of
    ``group`` (None: the world), in place: the same objects with the same
    parameters and buffers, so optimizers, hooks and references taken
    before stay valid. Returns ``module``."""
    for m in module.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = GlobalBatchNorm2d
        if isinstance(m, GlobalBatchNorm2d):
            m.group = group
    return module

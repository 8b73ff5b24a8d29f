"""Megatron tensor parallelism over the mesh's model axis.

JAX gets these collectives from GSPMD once ``parallel/sharding.py``'s
specs split the weights; the port writes them as ``torch.autograd``
functions, Megatron's conjugate pair:

  * ``copy_to_model`` -- identity forward, all-reduce of the gradient
    backward: in front of the column-split products (q / k / v, gate / up,
    the vocab-split CE), whose input every model rank holds whole;
  * ``reduce_from_model`` -- all-reduce forward, identity backward: after
    the row-split products (o, down) and the vocab-split embedding, whose
    outputs are partial sums.

Every model rank issues the same collectives in the same order, the
recompute of a ``torch.utils.checkpoint`` region included (its forward
runs again in the backward, all-reduce and all).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The model group of one rank: its index ``rank`` of ``size``."""

    group: dist.ProcessGroup
    rank: int
    size: int


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.tp.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=tp.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the model group."""
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``x`` summed over the model group; the gradient passed through."""
    return _ReduceFromModel.apply(x, tp)


def vocab_parallel_embed(weight: torch.Tensor, ids: torch.Tensor,
                         tp: TensorParallel) -> torch.Tensor:
    """Rows of a vocab-split ``[V / M, H]`` table (this rank's rows ``[m *
    V / M, (m + 1) * V / M)``): ids outside the shard give zero rows, and
    the sum over the model group is the whole lookup."""
    loc = ids - tp.rank * weight.shape[0]
    inside = (loc >= 0) & (loc < weight.shape[0])
    rows = weight[torch.where(inside, loc, torch.zeros_like(loc))]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_from_model(rows, tp)

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

Serving adds two forward-only collectives: ``gather_from_model``, the
all-gather of the vocab-split logits (``text.py:lm_logits``), and
``agree_max``, which gives every model rank the same host number (the
lookahead controller's walls, ``engine/speculative.py``), so that host
decisions cannot part the ranks' collectives.

Every model rank issues the same collectives in the same order, the
recompute of a ``torch.utils.checkpoint`` region included (its forward
runs again in the backward, all-reduce and all).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from livecc_tpu_torch.ops.quant import Weight, embed_lookup, is_quantized


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


def gather_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``[..., N / M]`` on every model rank -> ``[..., N]``, rank m's part
    at columns ``[m * N / M, (m + 1) * N / M)`` (forward only: one
    all-gather into a buffer of the whole, then the parts moved beside each
    other)."""
    x = x.contiguous()
    parts = x.new_empty((tp.size * x.shape[0], *x.shape[1:]))      # the ranks' x, stacked
    dist.all_gather_into_tensor(parts, x, group=tp.group)
    parts = parts.view(tp.size, *x.shape)
    return parts.movedim(0, -2).reshape(*x.shape[:-1], tp.size * x.shape[-1])


def agree_max(value: float, tp: TensorParallel) -> float:
    """The largest of the model ranks' ``value`` (one all-reduce of a
    tensor on the group's device: this rank's card for NCCL, else the CPU)."""
    nccl = dist.get_backend(tp.group) == "nccl"
    t = torch.tensor([value], dtype=torch.float64, device="cuda" if nccl else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=tp.group)
    return float(t.item())


def vocab_parallel_embed(weight: Weight, ids: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Rows of a vocab-split ``[V / M, H]`` table, plain or int8
    (``ops/quant.py:embed_lookup``: codes and per-row scales split
    together), this rank's rows ``[m * V / M, (m + 1) * V / M)``: ids
    outside the shard give zero rows, and the sum over the model group is
    the whole lookup."""
    n = (weight["q"] if is_quantized(weight) else weight).shape[0]
    loc = ids - tp.rank * n
    inside = (loc >= 0) & (loc < n)
    rows = embed_lookup(weight, torch.where(inside, loc, torch.zeros_like(loc)))
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_from_model(rows, tp)

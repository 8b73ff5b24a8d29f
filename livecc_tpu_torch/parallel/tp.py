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

Sequence parallelism (Megatron SP, JAX's ``seq_shard``: the residual
stream sharded ``[data, model, -]`` along the sequence) adds the
sequence conjugates. The sequence is dim 1 of ``[B, S, H]``; model rank m
holds the contiguous block ``[m S / M, (m + 1) S / M)``, as JAX's
``P(DATA, MODEL, None)`` lays it out:

  * ``gather_from_sequence`` -- all-gather along S forward, reduce-scatter
    of the gradient backward: in front of the column-split products, whose
    input gradients are partial sums over the model ranks' heads;
  * ``reduce_scatter_to_sequence`` -- reduce-scatter forward, all-gather
    backward: after the row-split products, whose outputs are partial sums;
  * ``split_to_sequence`` -- this rank's block forward, all-gather of the
    gradient backward: the tower's entry;
  * ``gather_sequence_exit`` -- all-gather forward, this rank's block of
    the gradient backward: the tower's exit, in front of the final norm
    and the vocab-parallel CE. The gradient that arrives there is already
    the whole sum on every model rank (``copy_to_model`` in front of the
    CE), so it is cut, never reduce-scattered (that would multiply it by M).

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


def all_gather_flat(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """The ranks' ``x`` stacked on dim 0 of ``out`` (torch's newer name where
    it has one; looked up at the call, so a wrapper set on ``dist`` sees it)."""
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def reduce_scatter_flat(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """This rank's dim-0 part of the sum of the ranks' ``x`` into ``out``."""
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, x, group=group)


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


def _gather_seq(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``[B, s, ...]`` blocks of every model rank -> ``[B, M s, ...]`` in rank order."""
    x = x.contiguous()
    parts = x.new_empty((tp.size * x.shape[0], *x.shape[1:]))      # the ranks' blocks, stacked
    all_gather_flat(parts, x, group=tp.group)
    parts = parts.view(tp.size, *x.shape).movedim(0, 1)
    return parts.reshape(x.shape[0], tp.size * x.shape[1], *x.shape[2:])


def _reduce_scatter_seq(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``[B, S, ...]`` partial sums -> this rank's block ``[B, S / M, ...]`` of their sum."""
    b, s = x.shape[:2]
    blocks = x.reshape(b, tp.size, s // tp.size, *x.shape[2:]).movedim(1, 0)
    blocks = blocks.reshape(tp.size * b, s // tp.size, *x.shape[2:])      # rank m's block m-th
    out = x.new_empty((b, s // tp.size, *x.shape[2:]))
    reduce_scatter_flat(out, blocks, group=tp.group)
    return out


def _own_block(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    n = x.shape[1] // tp.size
    return x[:, tp.rank * n:(tp.rank + 1) * n].contiguous()


class _GatherFromSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _gather_seq(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_seq(grad, ctx.tp), None


class _ReduceScatterToSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _reduce_scatter_seq(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _gather_seq(grad, ctx.tp), None


class _SplitToSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _own_block(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _gather_seq(grad, ctx.tp), None


class _GatherSequenceExit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _gather_seq(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _own_block(grad, ctx.tp), None


def gather_from_sequence(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """This rank's ``[B, S / M, H]`` block -> the whole ``[B, S, H]``; the
    gradient reduce-scattered back to the block."""
    return _GatherFromSequence.apply(x, tp)


def reduce_scatter_to_sequence(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``[B, S, H]`` partial sums -> this rank's block of their sum; the
    gradient all-gathered."""
    return _ReduceScatterToSequence.apply(x, tp)


def split_to_sequence(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The whole ``[B, S, H]`` (the same on every model rank) -> this rank's
    block; the gradient all-gathered."""
    return _SplitToSequence.apply(x, tp)


def gather_sequence_exit(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """This rank's block -> the whole ``[B, S, H]``; the gradient, the same
    whole tensor on every model rank, cut to this rank's block."""
    return _GatherSequenceExit.apply(x, tp)


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

"""Chunked softmax cross-entropy over the vocabulary projection.

Port of ``livecc_tpu/ops/chunked_ce.py`` (``_chunked``, ``chunked_cross_entropy``,
``cross_entropy_mean``, ``vocab_parallel_ce``). The full ``[seq, vocab]``
logits never exist at once; the sequence is cut into chunks of
``chunk_size`` positions:

  * ``impl="scan"`` — each chunk's loss runs under
    ``torch.utils.checkpoint``, so the backward recomputes its logits (four
    ``[chunk, H, V]`` matmul passes per chunk under autograd);
  * ``impl="fused"`` — a ``torch.autograd.Function`` whose forward computes
    the loss AND both gradients per chunk while the logits tile is live
    (``g = softmax - one_hot``, masked, rounded to the hidden dtype), so the
    backward only scales stored gradients: three matmul passes per chunk.
    The ``dkernel`` accumulator is fp32; ``kernel_grad=False`` skips it.

``lm_kernel`` is ``[H, V]`` as in JAX; the port's head weight is ``[V, H]``,
so callers pass ``weight.t()``, a view: the 545M-element table is never
copied. These are plain matmuls (XLA's in JAX), so ``torch.matmul`` serves.

Labels: ``IGNORE_INDEX`` (-100) is ignored; the loss returned is the SUM
over supervised positions, with their count (HF Trainer's per-token mean is
``cross_entropy_mean``).

``vocab_parallel_ce`` is the CE over a vocab-split head under tensor
parallelism: each model rank holds ``[H, V / M]`` columns and the whole
hidden state; the logsumexp is assembled from per-rank pieces by
collectives on ``[chunk]`` floats, never a ``[*, V]`` tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

IGNORE_INDEX = -100


def _chunked(hidden: torch.Tensor, labels: torch.Tensor, chunk_size: int):
    """Pad to a chunk multiple and reshape to chunk-major [N, B, C, ...]."""
    b, s, h = hidden.shape
    pad = -s % chunk_size
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=IGNORE_INDEX)
    n = hidden.shape[1] // chunk_size
    return (hidden.reshape(b, n, chunk_size, h).transpose(0, 1),
            labels.reshape(b, n, chunk_size).transpose(0, 1))


def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """2-D ``a @ b`` accumulated in fp32 and returned in ``out_dtype`` (JAX
    ``preferred_element_type``): one cuBLAS call with an fp32 output on CUDA;
    widened operands on the CPU."""
    if a.dtype == out_dtype:
        return a @ b
    if a.is_cuda and out_dtype == torch.float32:
        return torch.mm(a, b, out_dtype=out_dtype)
    return (a.float() @ b.float()).to(out_dtype)


def _chunk_loss(hid, lm_kernel, lab, out_dtype):
    b, c, h = hid.shape
    logits = _mm(hid.reshape(b * c, h), lm_kernel, out_dtype).float().reshape(b, c, -1)
    mask = lab != IGNORE_INDEX
    safe = torch.where(mask, lab, torch.zeros_like(lab)).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.where(mask, logz - gold, torch.zeros_like(logz)).sum()


def _scan_ce(hidden, lm_kernel, labels, chunk_size, out_dtype):
    hs, ls = _chunked(hidden, labels, chunk_size)
    loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for hid, lab in zip(hs, ls):
        if torch.is_grad_enabled():
            loss = loss + checkpoint(_chunk_loss, hid, lm_kernel, lab, out_dtype,
                                     use_reentrant=False)
        else:
            loss = loss + _chunk_loss(hid, lm_kernel, lab, out_dtype)
    return loss, (labels != IGNORE_INDEX).sum()


class _FusedCE(torch.autograd.Function):
    """Loss, count and both gradients in one pass over each logits tile."""

    @staticmethod
    def forward(ctx, hidden, lm_kernel, labels, chunk_size, out_dtype, kernel_grad):
        b, s, h = hidden.shape
        hs, ls = _chunked(hidden, labels, chunk_size)
        loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
        dhid = []
        # fp32 accumulator of d(loss)/d(kernel), kept [V, H] so that the
        # returned [H, V] gradient is a transposed view of a contiguous table
        dw = (torch.zeros(lm_kernel.shape[::-1], dtype=torch.float32, device=hidden.device)
              if kernel_grad else None)
        for hid, lab in zip(hs, ls):
            n = hid.shape[0] * hid.shape[1]
            flat = hid.reshape(n, h)
            lf = _mm(flat, lm_kernel, out_dtype).float()                 # [n, V]
            lab = lab.reshape(n)
            mask = lab != IGNORE_INDEX
            safe = torch.where(mask, lab, torch.zeros_like(lab)).long()
            logz = torch.logsumexp(lf, dim=-1)
            gold = torch.gather(lf, -1, safe[:, None])[:, 0]
            loss = loss + torch.where(mask, logz - gold, torch.zeros_like(logz)).sum()
            # grad of the summed CE wrt the logits, while the tile is live:
            # softmax minus one-hot, zero at unsupervised positions, rounded
            # to the hidden dtype for the two grad matmuls (fp32 accumulation)
            g = torch.exp(lf - logz[:, None])
            g[torch.arange(n, device=g.device), safe] -= 1.0
            g = g.mul_(mask[:, None]).to(hid.dtype)
            dhid.append(_mm(g, lm_kernel.t(), torch.float32).to(hid.dtype).reshape(hid.shape))
            if kernel_grad:
                dw += _mm(g.t(), flat, torch.float32)
        dhid = torch.stack(dhid).transpose(0, 1).reshape(b, -1, h)[:, :s]
        ctx.save_for_backward(dhid, dw.to(lm_kernel.dtype) if kernel_grad else None)
        ctx.kernel_grad = kernel_grad
        ctx.kernel_meta = (lm_kernel.shape, lm_kernel.dtype)
        count = (labels != IGNORE_INDEX).sum()
        ctx.mark_non_differentiable(count)
        return loss, count

    @staticmethod
    def backward(ctx, g_loss, _g_count):
        dhid, dw = ctx.saved_tensors
        g = g_loss.float()
        d_hidden = (g * dhid.float()).to(dhid.dtype)
        if ctx.kernel_grad:
            d_kernel = (g * dw.float()).to(dw.dtype).t()
        elif ctx.needs_input_grad[1]:
            # a frozen kernel's cotangent is zeros, as documented in JAX
            shape, dtype = ctx.kernel_meta
            d_kernel = torch.zeros(shape, dtype=dtype, device=dhid.device)
        else:
            d_kernel = None
        return d_hidden, d_kernel, None, None, None, None


def chunked_cross_entropy(
    hidden: torch.Tensor,        # [B, S, H] final hidden states (pre-lm_head)
    lm_kernel: torch.Tensor,     # [H, V] (the head weight's transposed view)
    labels: torch.Tensor,        # [B, S] int, -100 = ignore
    chunk_size: int = 1024,
    logit_dtype: torch.dtype | None = None,   # None = fp32 logits; bf16 = the fast path
    impl: str = "scan",          # "scan" (checkpoint-recompute) | "fused" (grads in fwd)
    kernel_grad: bool = True,    # fused only: False iff lm_kernel is frozen
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (summed loss fp32, count of supervised tokens).

    ``logit_dtype=torch.bfloat16`` rounds each chunk's logit rows to bf16 at
    the matmul output (fp32 accumulation inside it; logsumexp and the gold
    gather widen back to fp32)."""
    out_dtype = torch.float32 if logit_dtype is None else logit_dtype
    if impl == "fused":
        return _FusedCE.apply(hidden, lm_kernel, labels, chunk_size, out_dtype, kernel_grad)
    if impl != "scan":
        raise ValueError(f"chunked_cross_entropy: unknown impl {impl!r}")
    return _scan_ce(hidden, lm_kernel, labels, chunk_size, out_dtype)


def cross_entropy_mean(hidden, lm_kernel, labels, chunk_size: int = 1024,
                       logit_dtype=None) -> torch.Tensor:
    loss, count = chunked_cross_entropy(hidden, lm_kernel, labels, chunk_size=chunk_size,
                                        logit_dtype=logit_dtype)
    return loss / torch.clamp(count, min=1)


class _VocabParallelCE(torch.autograd.Function):
    """``_FusedCE`` over a vocab-split kernel: per chunk one all-reduce MAX
    of the row maxima (a shift, no gradient: JAX's ``_pmax_sg``) and one
    all-reduce SUM of the shifted sums of exponentials and the masked gold
    logits (JAX's two ``psum`` s, in one call)."""

    @staticmethod
    def forward(ctx, hidden, kernel, labels, tp, v_total, chunk_size, out_dtype, kernel_grad):
        b, s, h = hidden.shape
        v_shard = kernel.shape[1]
        v0 = tp.rank * v_shard
        hs, ls = _chunked(hidden, labels, chunk_size)
        loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
        dhid = []
        dw = (torch.zeros(kernel.shape[::-1], dtype=torch.float32, device=hidden.device)
              if kernel_grad else None)
        pad_cols = None
        if v_shard * tp.size != v_total:        # the pad columns of the last shard
            pad_cols = v0 + torch.arange(v_shard, device=hidden.device) >= v_total
        for hid, lab in zip(hs, ls):
            n = hid.shape[0] * hid.shape[1]
            flat = hid.reshape(n, h)
            lf = _mm(flat, kernel, out_dtype).float()                    # [n, V / M]
            if pad_cols is not None:
                lf = lf.masked_fill(pad_cols, -1e30)
            lab = lab.reshape(n)
            mask = lab != IGNORE_INDEX
            loc = torch.where(mask, lab, torch.zeros_like(lab)).long() - v0
            inside = (loc >= 0) & (loc < v_shard)
            loc = loc.clamp(0, v_shard - 1)
            gmax = lf.amax(dim=-1)
            dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=tp.group)
            parts = torch.stack([(lf - gmax[:, None]).exp().sum(dim=-1),
                                 torch.where(inside, torch.gather(lf, -1, loc[:, None])[:, 0],
                                             torch.zeros_like(gmax))])
            dist.all_reduce(parts, group=tp.group)
            logz = parts[0].log() + gmax
            loss = loss + torch.where(mask, logz - parts[1], torch.zeros_like(logz)).sum()
            # softmax minus one-hot over this rank's columns, as _FusedCE
            g = torch.exp(lf - logz[:, None])
            g[torch.arange(n, device=g.device), loc] -= inside.to(g.dtype)
            g = g.mul_(mask[:, None]).to(hid.dtype)
            dhid.append(_mm(g, kernel.t(), torch.float32).to(hid.dtype).reshape(hid.shape))
            if kernel_grad:
                dw += _mm(g.t(), flat, torch.float32)
        dhid = torch.stack(dhid).transpose(0, 1).reshape(b, -1, h)[:, :s]
        ctx.save_for_backward(dhid, dw.to(kernel.dtype) if kernel_grad else None)
        ctx.kernel_grad = kernel_grad
        ctx.kernel_meta = (kernel.shape, kernel.dtype)
        count = (labels != IGNORE_INDEX).sum()
        ctx.mark_non_differentiable(count)
        return loss, count

    @staticmethod
    def backward(ctx, g_loss, _g_count):
        d_hidden, d_kernel = _FusedCE.backward(ctx, g_loss, _g_count)[:2]
        return d_hidden, d_kernel, None, None, None, None, None, None


def vocab_parallel_ce(
    hidden: torch.Tensor,        # [B, S, H], the same on every model rank
    kernel: torch.Tensor,        # [H, V / M]: this rank's columns [m V / M, (m + 1) V / M)
    labels: torch.Tensor,        # [B, S] int, -100 = ignore
    *,
    tp,                          # parallel/tp.py:TensorParallel
    v_total: int,                # the unpadded vocab; pad columns past it are masked
    chunk_size: int = 1024,
    logit_dtype: torch.dtype | None = None,
    kernel_grad: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(summed loss fp32, supervised count), the same on every model rank:
    JAX's ``vocab_parallel_ce`` (``ops/chunked_ce.py:214``), with the
    gradients computed in the forward as ``impl="fused"``. The gradient of
    ``hidden`` is this rank's partial sum: the caller sums it over the
    model group (``parallel/tp.py:copy_to_model`` in front of the call);
    the kernel's stays with its shard."""
    out_dtype = torch.float32 if logit_dtype is None else logit_dtype
    return _VocabParallelCE.apply(hidden, kernel, labels, tp, v_total, chunk_size, out_dtype,
                                  kernel_grad)

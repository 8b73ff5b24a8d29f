"""K4: the splash training attention, forward and backward.

Port of the kernels behind ``livecc_tpu/ops/attention.py:train_flash_attention``
(``_train_splash``, JAX's Pallas splash MQA; ``_train_flash_stock`` has the
same contract and is served by the same kernel). Layouts as in JAX:

  * ``qs`` ``[B, S, Hq, D]`` — q already scaled by ``d**-0.5`` and rounded to
    its dtype (``ops/attention.py:train_flash_attention`` does that outside
    the autograd function, so autograd carries the chain rule);
  * ``k``, ``v`` ``[B, S, Hk, D]``, GQA with ``G = Hq / Hk``;
  * ``seg`` int32 ``[B, S]`` segment ids: query i attends key j iff
    ``seg[i] == seg[j]`` and, in the causal form (the default, splash's
    ``CausalMask``), ``j <= i``; ``causal=False`` drops the second term
    (splash's ``FullMask``). Pad tokens (id 0) attend among themselves, as
    in splash.

``TrainAttention`` is the ``torch.autograd.Function``: its forward keeps
``(qs, k, v, seg, o, lse)``, its backward returns dq, dk and dv in the
operands' dtypes. CUDA tensors go to ``csrc/train_attention_fwd.cu`` and
``csrc/train_attention_bwd.cu`` (launch counts ``train_attention_fwd`` and
``train_attention_bwd``), CPU tensors to the plain versions below; any
other device raises. On the card, bf16 operands run on the tensor cores
(the forward on ``csrc/train_wgmma_attention.cuh``, the backward on
``csrc/train_wgmma_attention_bwd.cuh``: a head dim that is a multiple of 16 and
16-byte aligned rows, ``build.check_bf16_rows``), fp32 operands on the FMA
pipes (``csrc/train_attention.cuh``). The plain versions keep splash's
numerics: fp32 scores, masked scores at ``-0.7 * finfo(float32).max``, p
fp32 against V widened to fp32, normalisation at the end, ``lse = m + log
l``; in the backward ``p.to(do.dtype)`` for dv, ``ds = p * (dp - di)``
rounded to ``do``'s dtype for dk and to k's for dq, every product in fp32.
"""

from __future__ import annotations

import torch

from livecc_tpu_torch.ops import build

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)   # splash DEFAULT_MASK_VALUE


def _allowed(seg: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """bool [B, 1, S, S]: query i may attend key j."""
    ok = seg[:, :, None] == seg[:, None, :]
    if causal:
        pos = torch.arange(seg.shape[1], device=seg.device)
        ok = ok & (pos[None, :] <= pos[:, None])
    return ok[:, None]


def _heads(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, H, D] -> fp32 [B, H * groups, S, D] (KV heads repeated per group)."""
    x = x.transpose(1, 2)
    if groups > 1:
        x = x.repeat_interleave(groups, dim=1)
    return x.float()


def train_attention_fwd_plain(qs, k, v, seg, causal: bool = True):
    """Plain version of the forward kernel: (o [B, S, Hq, D] in qs's dtype,
    lse fp32 [B, Hq, S])."""
    g = qs.shape[2] // k.shape[2]
    qt, kt, vt = _heads(qs, 1), _heads(k, g), _heads(v, g)
    s = torch.matmul(qt, kt.transpose(-1, -2))                          # [B, Hq, S, S]
    s = torch.where(_allowed(seg, causal), s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True).detach()       # the softmax does not depend on m
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, vt) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return o.transpose(1, 2).to(qs.dtype), lse


def train_attention_bwd_plain(qs, k, v, seg, o, lse, do, causal: bool = True):
    """Plain version of the backward kernels: (dq for qs, dk, dv)."""
    b, s, hq, d = qs.shape
    hk = k.shape[2]
    g = hq // hk
    qt, kt, vt = _heads(qs, 1), _heads(k, g), _heads(v, g)
    dot = do.transpose(1, 2)                                            # [B, Hq, S, D]
    allowed = _allowed(seg, causal)
    sc = torch.matmul(qt, kt.transpose(-1, -2))
    p = torch.where(allowed, torch.exp(sc - lse[..., None]), torch.zeros_like(sc))
    di = (o.float() * do.float()).sum(-1).transpose(1, 2)               # [B, Hq, S]
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dot.float())
    dp = torch.matmul(dot.float(), vt.transpose(-1, -2))
    ds = p * (dp - di[..., None])
    dk = torch.matmul(ds.to(do.dtype).float().transpose(-1, -2), qt)
    dq = torch.matmul(ds.to(k.dtype).float(), kt)
    dk = dk.reshape(b, hk, g, s, d).sum(2)
    dv = dv.reshape(b, hk, g, s, d).sum(2)
    return (dq.transpose(1, 2).to(qs.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _check(name: str, qs, k, v, seg, *more) -> None:
    build.check_operands(name, qs, k, v, *more)
    build.check_bf16_rows(name, qs, k, v, *more)
    b, s, hq, d = qs.shape
    hk = k.shape[2]
    if k.shape != (b, s, hk, d) or v.shape != k.shape or hq % hk:
        raise ValueError(f"{name}: shapes qs {tuple(qs.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if seg.shape != (b, s) or seg.dtype != torch.int32 or seg.device != qs.device:
        raise ValueError(f"{name}: segment ids must be int32 [B, S] = {(b, s)} on {qs.device}, "
                         f"got {seg.dtype} {tuple(seg.shape)} on {seg.device}")


def _device(name: str, x: torch.Tensor) -> bool:
    """True for CUDA (the kernel), False for the CPU (the plain version)."""
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    return x.device.type == "cuda"


def train_attention_fwd(qs, k, v, seg, causal: bool = True):
    """Forward: (o [B, S, Hq, D], lse fp32 [B, Hq, S])."""
    if not _device("train_attention_fwd", qs):
        return train_attention_fwd_plain(qs, k, v, seg, causal)
    _check("train_attention_fwd", qs, k, v, seg)
    b, s, hq, d = qs.shape
    hk = k.shape[2]
    seg = seg.contiguous()
    o = torch.empty((b, s, hq, d), dtype=qs.dtype, device=qs.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=qs.device)
    lib = build.load_library()
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        build.launch(
            "train_attention_fwd", lib.livecc_train_attention_fwd,
            build.DTYPE_CODES[qs.dtype], qs.data_ptr(), k.data_ptr(), v.data_ptr(),
            seg.data_ptr(), o.data_ptr(), lse.data_ptr(), b, hq, hk, s, d, int(causal),
            build.stride_array((qs, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2))), stream,
        )
    return o, lse


def train_attention_bwd(qs, k, v, seg, o, lse, do, causal: bool = True):
    """Backward: (dq for qs, dk, dv) in the operands' dtypes."""
    if not _device("train_attention_bwd", qs):
        return train_attention_bwd_plain(qs, k, v, seg, o, lse, do, causal)
    do = do.to(qs.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    _check("train_attention_bwd", qs, k, v, seg, do)
    b, s, hq, d = qs.shape
    hk = k.shape[2]
    seg = seg.contiguous()
    lse = lse.contiguous()
    di = torch.einsum("bshd,bshd->bhs", o.float(), do.float()).contiguous()   # rowsum(o * do)
    dq = torch.empty((b, s, hq, d), dtype=qs.dtype, device=qs.device)
    dk = torch.empty((b, s, hk, d), dtype=k.dtype, device=qs.device)
    dv = torch.empty((b, s, hk, d), dtype=v.dtype, device=qs.device)
    lib = build.load_library()
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        build.launch(
            "train_attention_bwd", lib.livecc_train_attention_bwd,
            build.DTYPE_CODES[qs.dtype], qs.data_ptr(), k.data_ptr(), v.data_ptr(),
            seg.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, hq, hk, s, d, int(causal),
            build.stride_array((qs, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                               (do, (0, 1, 2))), stream,
        )
    return dq, dk, dv


class TrainAttention(torch.autograd.Function):
    """``o = attention(qs, k, v | seg)`` with the K4 kernels forward and
    backward; ``causal`` picks the form (both count as K4's launches)."""

    @staticmethod
    def forward(ctx, qs, k, v, seg, causal=True):
        o, lse = train_attention_fwd(qs, k, v, seg, causal)
        ctx.save_for_backward(qs, k, v, seg, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, seg, o, lse = ctx.saved_tensors
        dq, dk, dv = train_attention_bwd(qs, k, v, seg, o, lse, do, ctx.causal)
        return dq, dk, dv, None, None

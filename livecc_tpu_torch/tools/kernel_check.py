"""Hold the attention kernels (K1, K1-int8, K2, K2-int8, K3, K4) and the
int8-weight GEMM (K5) to their plain versions, by limits that a dropped
block of keys (or of K5's contraction) fails.

``close(out, ref, dtype)`` compares a kernel's output with the plain version
on the same inputs in the same dtype (the plain versions on bf16 tensors
round p to bf16 as the kernels do): elementwise

    |out - ref| <= rtol * |ref| + atol * rms(ref's row)

with bf16 (1e-2, 2e-2) and fp32 (1e-4, 1e-4), the limits of the K4 check
in ``chip_smoke.py``. bf16's rtol is just above one bf16 step (2^-7
relative), all that a rounding flip moves an output. The rms is taken over
each output row (the last dim, one query head of one query), since
rows at different cache depths differ in scale by orders of magnitude: a
row over one key is a V row (~1), one over 8192 keys ~0.05. It returns the
worst share of the limit used; above 1 fails.

The planted faults, what a kernel that skipped one block of its loop would
give; a check that passes them could not see a lost block:

  * ``drop_split(...)`` (K2): the plain version with the keys ``[split,
    2 * split)`` of the longest row removed for one KV head's query heads;
  * ``drop_key_tile(...)`` (K1, K1-int8) and ``vit_drop_key_tile(...)`` (K3): the
    plain output with one 64-query tile of one head recomputed without one
    64-key tile (``TILE``, the kernels' ``kMmaTileQ`` / ``kMmaTileK``,
    ``kQuantTileQ`` / ``kQuantTileK``);
  * ``dropped_tile(...)`` (K4): the plain forward and backward outputs (o,
    lse, dq, dk, dv) without one 64 x 64 tile pair of one q head (``TILE``,
    ``kTrainMmaTileQ`` / ``kTrainMmaTileK`` of ``train_mma_attention.cuh``);
    ``dropped_fwd_tile(...)`` the forward's two alone;
  * ``zeroed_k3_backward()`` (K3's gradient): while it is entered, the
    backward of K3's autograd ``Function`` returns zeros, as the port
    passed no gradient through K3 before it had one;
  * ``w8_drop_split(...)`` (K5's small form): the plain output with one
    128-column block computed without one of its K splits
    (``ops/quant.py:small_split``); ``w8_drop_k_tile(...)`` (K5's large
    form): one output tile of ``large_plan``'s tiling (its token tile x
    128 columns) computed without one 64-wide K stage of one of its splits.

Where a plain version cannot run whole (the MCQ item's S = 32768 forward,
its 32 ViT groups of 2880), ``train_attention_fwd_blocked`` and
``vit_group_attention_blocked`` compute it in blocks of independent rows
or groups.

bf16 K4's gradients (dq, dk, dv) are held by ``grad_close(out, ref, ref32)``
instead: each gradient sums thousands of bf16-rounded terms (p, ds), so two
valid bf16 computations of it can differ by more than ``close``'s bf16 limit
(dq at S = 8192 did, with the kernel the nearer of the two to the fp32
result). ``grad_close`` measures the kernel's distance from the fp32 plain
version, elementwise within

    rtol * |ref32| + GRAD_SPREAD * max over the row |ref - ref32|
                   + GRAD_FLOOR * rms(ref32)

where ``ref`` is the bf16 plain version on the kernel's inputs: the bf16
reference's own worst stray from fp32 in that output row (the last dim),
doubled, sets what rounding of the same work allows, ``rtol`` (bf16's,
just above one bf16 step) covers the output's own rounding, and a floor of
a thousandth of the gradient's rms covers rows whose value cancels to
about 0 (a query whose segment holds one key: ds = p (dp - di) with o = v),
where only the fp32 summation order speaks, which the two plain versions
share and the kernel does not. ``dropped_tile``'s gradients must fail it.

bf16 K1-int8 keeps JAX's fp32 ``p * v_scale`` by splitting it into three
bf16 parts. ``close`` cannot see one part in place of three: its worst
share is set by the largest single rounding flip of the bf16 output, which
an exact kernel also makes somewhere among millions of outputs. What one
part changes is how often the output rounds the other way.
``rounding_flips(out, ref32)`` is that share: of ``out``'s elements, those
that differ from the fp32 plain version rounded to bf16. A kernel that
keeps the fp32 product flips where the order of its fp32 sums moves an
output across a rounding boundary (well under ``FLIP_LIMIT``);
``one_part_pv(...)``, the planted fault, rounds ``p * v_scale`` to bf16 once
and flips about 40% of its outputs.
"""

from __future__ import annotations

import contextlib

import torch

from livecc_tpu_torch.ops import build
from livecc_tpu_torch.ops.attention import NEG_INF
from livecc_tpu_torch.ops.flash_attention import _masked_softmax_pv, _scores

TOL = {torch.bfloat16: (1e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
TILE = 64       # queries and keys per tile: kMmaTileQ, kMmaTileK of csrc/mma_attention.cuh,
                # kQuantTileQ, kQuantTileK of csrc/quant_mma_attention.cuh,
                # kTrainMmaTileQ, kTrainMmaTileK of csrc/train_mma_attention.cuh
FLIP_LIMIT = 1e-2   # rounding_flips: one output in a hundred off the fp32 result's rounding
GRAD_SPREAD = 2.0   # grad_close: twice the bf16 reference's worst stray from fp32 in the row
GRAD_FLOOR = 1e-3   # grad_close: and a thousandth of the gradient's rms


def close(out: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype) -> float:
    """Worst share of the limit ``rtol |ref| + atol rms(row of ref)`` that
    ``|out - ref|`` uses (<= 1 passes). Raises on a shape mismatch or a
    non-finite output."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"shape {tuple(out.shape)} vs {tuple(ref.shape)} or non-finite output")
    rtol, atol = TOL[dtype]
    lim = rtol * ref.abs() + atol * ref.square().mean(dim=-1, keepdim=True).sqrt()
    diff = (out - ref).abs()
    share = torch.where(diff == 0, torch.zeros_like(diff), diff / lim)
    return share.max().item()


def grad_close(out: torch.Tensor, ref: torch.Tensor, ref32: torch.Tensor) -> float:
    """Worst share of the limit ``rtol |ref32| + GRAD_SPREAD * max over the
    row |ref - ref32| + GRAD_FLOOR * rms(ref32)`` (bf16's rtol) that
    ``|out - ref32|`` uses (<= 1 passes): a bf16 gradient ``out`` against
    the fp32 plain version
    ``ref32``, with the bf16 plain version ``ref`` on the same inputs
    setting the rounding it may carry. Raises on a shape mismatch or a
    non-finite output."""
    out, ref, ref32 = out.float(), ref.float(), ref32.float()
    if not out.shape == ref.shape == ref32.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"shapes {tuple(out.shape)}, {tuple(ref.shape)}, "
                             f"{tuple(ref32.shape)} or non-finite output")
    spread = (ref - ref32).abs().amax(dim=-1, keepdim=True)
    lim = (TOL[torch.bfloat16][0] * ref32.abs() + GRAD_SPREAD * spread
           + GRAD_FLOOR * ref32.square().mean().sqrt())
    diff = (out - ref32).abs()
    share = torch.where(diff == 0, torch.zeros_like(diff), diff / lim)
    return share.max().item()


def rounding_flips(out: torch.Tensor, ref32: torch.Tensor) -> float:
    """Share of ``out``'s elements that differ from ``ref32`` (fp32, the
    plain version computed in fp32 on the same inputs) rounded to
    ``out``'s dtype. Raises on a shape mismatch."""
    if out.shape != ref32.shape:
        raise AssertionError(f"shape {tuple(out.shape)} vs {tuple(ref32.shape)}")
    return (out != ref32.to(out.dtype)).float().mean().item()


def one_part_pv(q, k, v, offset, kv_limit, k_scale, v_scale) -> torch.Tensor:
    """``flash_prefill_plain`` of an int8 cache in fp32 (q widened exactly)
    with ``p * v_scale`` rounded to bf16 once before it meets V: what a
    K1-int8 that fed the product to the tensor cores as one bf16 part would
    compute, before its output is rounded. fp32 ``[B, Hq, Sq, D]``."""
    b, hq, sq, _ = q.shape
    g = hq // k.shape[1]
    off = build.row_scalars(offset, b, q.device)
    lim = build.row_scalars(kv_limit, b, q.device)
    s = _scores(q.float(), k, k_scale)
    qpos = off[:, None] + torch.arange(sq, device=q.device)[None, :]
    kpos = torch.arange(k.shape[2], device=q.device)
    allowed = ((kpos[None, None, :] <= qpos[:, :, None]) &
               (kpos[None, None, :] < lim[:, None, None]))[:, None]
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    p = torch.where(allowed, torch.exp(s - s.amax(dim=-1, keepdim=True)), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    pv = (p * v_scale.repeat_interleave(g, dim=1).float()).to(torch.bfloat16).float()
    o = torch.matmul(pv, v.repeat_interleave(g, dim=1).float())
    return o / torch.where(l > 0, l, torch.ones_like(l))


def drop_split(q, k, v, kv_limit, split: int, k_scale=None, v_scale=None,
               kv_head: int = 0) -> torch.Tensor:
    """``flash_decode_plain`` on a one-layer cache with the keys ``[split,
    2 * split)`` of the longest row left out for the query heads of
    ``kv_head`` (int8 with scales)."""
    b, hq = q.shape[:2]
    hk, smax = k.shape[1], k.shape[2]
    g = hq // hk
    lim = build.row_scalars(kv_limit, b, q.device)
    row = int(lim.argmax())
    if min(int(lim[row]), smax) <= split:
        raise ValueError(f"drop_split: the longest row ({int(lim[row])} keys) has one split "
                         f"of {split} or less")
    allowed = torch.arange(smax, device=q.device)[None, :] < lim[:, None]
    allowed = allowed[:, None, None, :].expand(b, hq, 1, smax).clone()
    allowed[row, kv_head * g:(kv_head + 1) * g, :, split:2 * split] = False
    return _masked_softmax_pv(_scores(q, k, k_scale), allowed, v, q.dtype, v_scale)


def drop_key_tile(ref, q, k, v, offset, kv_limit, q_tile: int, k_tile: int, head: int = 0,
                  row: int = 0, k_scale=None, v_scale=None) -> torch.Tensor:
    """``ref`` (``flash_prefill_plain`` on these inputs, ``[B, Hq, Sq, D]``,
    one-layer cache ``[B, Hk, Smax, D]``; an int8 cache with its scales
    ``[B, Hk, 1, Smax]``) with the queries ``[TILE * q_tile, +TILE)`` of q
    head ``head`` in batch row ``row`` recomputed without the keys ``[TILE *
    k_tile, +TILE)``. Raises if those queries attend none of those keys (the
    fault would change nothing)."""
    b, hq, sq, _ = q.shape
    kvh = head // (hq // k.shape[1])
    off = int(build.row_scalars(offset, b, q.device)[row])
    lim = int(build.row_scalars(kv_limit, b, q.device)[row])
    if not 0 <= q_tile * TILE < sq:
        raise ValueError(f"drop_key_tile: no query tile {q_tile} in {sq} queries")
    rows = slice(q_tile * TILE, min(sq, (q_tile + 1) * TILE))
    cols = slice(k_tile * TILE, (k_tile + 1) * TILE)
    qs = q[row:row + 1, head:head + 1, rows]
    ks, vs = k[row:row + 1, kvh:kvh + 1], v[row:row + 1, kvh:kvh + 1]
    kss, vss = ((None if x is None else x[row:row + 1, kvh:kvh + 1]) for x in (k_scale, v_scale))
    qpos = off + torch.arange(rows.start, rows.stop, device=q.device)
    kpos = torch.arange(k.shape[2], device=q.device)
    allowed = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < lim)
    if not bool(allowed[:, cols].any()):
        raise ValueError(f"drop_key_tile: query tile {q_tile} attends no key of tile {k_tile}")
    allowed[:, cols] = False
    out = ref.clone()
    out[row, head, rows] = _masked_softmax_pv(_scores(qs, ks, kss), allowed[None, None], vs,
                                              ref.dtype, vss)[0, 0]
    return out


def vit_drop_key_tile(ref, q, k, v, cu_seqlens, seg: int, q_tile: int, k_tile: int,
                      head: int = 0) -> torch.Tensor:
    """``ref`` (the plain output ``[N, H, D]`` of K3's bounds form) with the
    query tile ``q_tile`` of head ``head`` in segment ``seg`` recomputed
    without the segment's key tile ``k_tile``: ``drop_key_tile`` on the
    segment, seen as one batch row whose queries all sit past its keys."""
    a, e = (int(x) for x in cu_seqlens[seg:seg + 2])
    n = e - a
    bhsd = [x[a:e].transpose(0, 1)[None] for x in (ref, q, k, v)]
    out = ref.clone()
    out[a:e] = drop_key_tile(*bhsd, n, n, q_tile, k_tile, head)[0].transpose(0, 1)
    return out


def _tile_p(qs, k, seg, lse, qt: int, kt: int, h: int):
    """(query rows, key columns, KV head, fp32 q and k of the tile pair, its
    probabilities p) of key tile ``kt`` for query tile ``qt`` of q head ``h``
    in batch row 0, from the plain forward's ``lse``."""
    kvh = h // (qs.shape[2] // k.shape[2])
    rows, cols = slice(qt * TILE, qt * TILE + TILE), slice(kt * TILE, kt * TILE + TILE)
    q_, k_ = qs[0, rows, h].float(), k[0, cols, kvh].float()
    pos = torch.arange(qs.shape[1], device=qs.device)
    ok = (seg[0, rows, None] == seg[0, None, cols]) & (pos[None, cols] <= pos[rows, None])
    p = torch.where(ok, torch.exp(q_ @ k_.T - lse[0, h, rows, None]),
                    torch.zeros((), device=qs.device))
    return rows, cols, kvh, q_, k_, p


def dropped_fwd_tile(qs, k, v, seg, o, lse, qt: int, kt: int, h: int):
    """The plain forward's (o, lse) as K4's forward would give them had it
    dropped key tile ``kt`` for query tile ``qt`` of q head ``h`` (batch row
    0): the tile's share of the softmax removed. ``o`` and ``lse`` are the
    plain version's on these inputs."""
    rows, cols, kvh, _, _, p = _tile_p(qs, k, seg, lse, qt, kt, h)
    o_, v_ = o[0, rows, h].float(), v[0, cols, kvh].float()
    mass = p.sum(-1)
    o2, lse2 = o.clone(), lse.clone()
    o2[0, rows, h] = ((o_ - p @ v_) / (1 - mass)[:, None]).to(o.dtype)
    lse2[0, h, rows] += torch.log1p(-mass)
    return o2, lse2


def dropped_tile(qs, k, v, seg, do, o, lse, grads, qt: int, kt: int, h: int):
    """The plain outputs (o, lse, dq, dk, dv of batch row 0) as a K4 kernel
    would give them had it dropped one tile pair: key tile ``kt`` for query
    tile ``qt`` of q head ``h`` (``TILE`` x ``TILE``, the unit the kernels
    skip). The forward loses that tile's share of the softmax
    (``dropped_fwd_tile``); each gradient loses the pair's terms, rounded as
    the kernels round p and ds. ``o``, ``lse`` and ``grads`` are the plain
    versions' on these inputs."""
    rows, cols, kvh, q_, k_, p = _tile_p(qs, k, seg, lse, qt, kt, h)
    do_, o_ = do[0, rows, h].float(), o[0, rows, h].float()
    v_ = v[0, cols, kvh].float()
    ds = p * (do_ @ v_.T - (o_ * do_).sum(-1, keepdim=True))
    o2, lse2 = dropped_fwd_tile(qs, k, v, seg, o, lse, qt, kt, h)
    dq, dk, dv = (x.clone() for x in grads)
    dq[0, rows, h] = (dq[0, rows, h].float() - ds.to(k.dtype).float() @ k_).to(dq.dtype)
    dk[0, cols, kvh] = (dk[0, cols, kvh].float() - ds.to(do.dtype).float().T @ q_).to(dk.dtype)
    dv[0, cols, kvh] = (dv[0, cols, kvh].float() - p.to(do.dtype).float().T @ do_).to(dv.dtype)
    return o2, lse2, dq, dk, dv


def train_attention_fwd_blocked(qs, k, v, seg, rows: int = 1024):
    """``train_attention_fwd_plain`` computed ``rows`` query rows at a time,
    for shapes whose whole ``[B, Hq, S, S]`` scores do not fit (S = 32768:
    120 GB). Each block runs the plain version's operations on its rows
    against the keys up to its last row (later keys are masked for every
    row of the block, and their exp is 0): ``[B, Hq, rows, <= S]`` fp32
    scores, 3.8 GB at the MCQ shape. (o, lse) as the plain version's."""
    from livecc_tpu_torch.ops.train_attention import MASK_VALUE, _heads

    b, s, hq, d = qs.shape
    g = hq // k.shape[2]
    o = torch.empty((b, s, hq, d), dtype=qs.dtype, device=qs.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=qs.device)
    pos = torch.arange(s, device=qs.device)
    for a in range(0, s, rows):
        e = min(s, a + rows)
        qt, kt, vt = _heads(qs[:, a:e], 1), _heads(k[:, :e], g), _heads(v[:, :e], g)
        sc = torch.matmul(qt, kt.transpose(-1, -2))                      # [B, Hq, r, e]
        ok = (seg[:, a:e, None] == seg[:, None, :e]) & (pos[None, :e] <= pos[a:e, None])
        sc = torch.where(ok[:, None], sc, torch.full_like(sc, MASK_VALUE))
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - m)
        del sc
        l = p.sum(dim=-1, keepdim=True)
        o[:, a:e] = (torch.matmul(p, vt) / l).transpose(1, 2).to(qs.dtype)
        lse[:, :, a:e] = (m + torch.log(l)).squeeze(-1)
        del p, qt, kt, vt
    return o, lse


def vit_group_attention_blocked(q, k, v):
    """``vit_group_attention_plain`` group by group (``[NG, g, H, D]``): at
    NG = 32, g = 2880 the whole version's fp32 scores take 17 GB, one
    group's 0.53 GB."""
    from livecc_tpu_torch.ops.vit_attention import vit_group_attention_plain

    return torch.cat([vit_group_attention_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1])
                      for i in range(q.shape[0])])


@contextlib.contextmanager
def zeroed_k3_backward():
    """Plant the K3 gradient fault: ``ops/vit_attention.py:_K3``'s backward
    returns zero gradients for q, k and v until the context exits."""
    from livecc_tpu_torch.ops import vit_attention

    saved = vit_attention._K3.__dict__["backward"]
    vit_attention._K3.backward = staticmethod(
        lambda ctx, grad: (None, None, *(torch.zeros_like(x) for x in ctx.saved_tensors)))
    try:
        yield
    finally:
        vit_attention._K3.backward = saved


def _w8_without(x, q, scale, out_dtype, rows: slice, cols: slice, k0: int, k1: int):
    """``w8a16_gemm_plain`` of ``x [M, K]`` with the block ``[rows, cols]``
    recomputed without the contraction range ``[k0, k1)``."""
    from livecc_tpu_torch.ops.quant import w8a16_gemm_plain

    out = w8a16_gemm_plain(x, q, scale, out_dtype)
    cut = q[cols].clone()
    cut[:, k0:k1] = 0
    out[rows, cols] = w8a16_gemm_plain(x[rows], cut, scale[cols], out_dtype)
    return out


def w8_drop_split(x, q, scale, out_dtype=None, block: int = 0, split: int | None = None):
    """K5's small form had one block skipped: column block ``block``
    (``SMALL_BLOCK_N`` columns) without the K range of split ``split`` (by
    default the middle one) of ``small_split``."""
    from livecc_tpu_torch.ops.quant import SMALL_BLOCK_N, small_split

    n, k = q.shape
    nsplit, split_k = small_split(n, k)
    s = nsplit // 2 if split is None else split
    cols = slice(block * SMALL_BLOCK_N, min(n, (block + 1) * SMALL_BLOCK_N))
    return _w8_without(x, q, scale, out_dtype, slice(None), cols, s * split_k,
                       min(k, (s + 1) * split_k))


def w8_drop_k_tile(x, q, scale, out_dtype=None, m_block: int = 0, n_block: int = 0,
                   split: int | None = None, stage: int | None = None):
    """K5's large form had one stage skipped: output tile (``m_block``,
    ``n_block``) of ``large_plan``'s tiling (its token tile of rows x
    ``LARGE_ROWS`` columns) without one 64-wide K stage, stage ``stage`` of
    split ``split`` of the plan's K ranges (by default the middle of each)."""
    from livecc_tpu_torch.ops.quant import K_TILE, LARGE_ROWS, large_plan

    m, (n, k) = x.shape[0], q.shape
    tile, nsplit, split_k = large_plan(m, n, k)
    k0 = (nsplit // 2 if split is None else split) * split_k
    t = -(-(min(k, k0 + split_k) - k0) // K_TILE) // 2 if stage is None else stage
    rows = slice(m_block * tile, min(m, (m_block + 1) * tile))
    cols = slice(n_block * LARGE_ROWS, min(n, (n_block + 1) * LARGE_ROWS))
    return _w8_without(x, q, scale, out_dtype, rows, cols, k0 + t * K_TILE,
                       min(k, k0 + (t + 1) * K_TILE))

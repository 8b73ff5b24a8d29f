"""K4's bf16 tensor-core kernels, their tile-wise arithmetic emulated in
PyTorch on the CPU: the forward (``csrc/train_wgmma_attention.cuh``) and the
backward (``csrc/train_wgmma_attention_bwd.cuh``).

The kernels run only on the card; what they compute is written out here
tile by tile and held to the references in bf16 by ``kernel_check.close``:

  * the forward's blocks of 128 queries walk 64-key tiles with a running
    max, masked scores at splash's mask value giving p = 0, and P·V as
    three bf16 products of p split into hi = bf16(p), mid = bf16(p - hi),
    lo = bf16(p - hi - mid) (``kPTerms``) into one fp32 accumulator;
  * the backward's dK/dV kernel works in the transposed form: blocks of
    128 keys (64 a warpgroup, each summing its own keys' rows: no partial
    sums to merge) walk the group's q heads and, per head, their live
    64-query tiles in order, each tile in one pass of 64 queries, P^T and
    dS^T rounded to bf16 as the A operands of dV += P^T dO and dK += dS^T
    Q; the dQ kernel's blocks of 128 queries walk 64-key tiles and round
    dS to bf16 for dQ += dS K;
  * every kernel walks only its live tiles (``live_tiles``: the tiles that
    hold one of the block's ids), the forward's and dQ's up to the
    diagonal and dK/dV's from it on in the causal form, all of them in the
    non-causal one (``causal=False``, splash's ``FullMask``).

The references: JAX ``_train_splash`` in interpret mode (the Pallas splash
kernels on the CPU) and the port's plain versions, causal and not; the
planted faults, ``kernel_check.dropped_tile`` (one 64 x 64 tile pair
dropped) and, for the non-causal form, ``kernel_check.causal_walk`` (the
causal walk and mask kept), must fail.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livecc_tpu.ops import attention as jattn

import livecc_tpu_torch
from livecc_tpu_torch.ops.attention import prescaled
from livecc_tpu_torch.ops.train_attention import (
    MASK_VALUE, _allowed, train_attention_bwd_plain, train_attention_fwd_plain)
from livecc_tpu_torch.tools import kernel_check
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TILE = kernel_check.TILE        # the tiles the kernels stream: 64 keys or queries
BF16 = torch.bfloat16
CSRC = Path(livecc_tpu_torch.__file__).parent / "csrc"
FWD_HEADER = CSRC / "train_wgmma_attention.cuh"
BWD_HEADER = CSRC / "train_wgmma_attention_bwd.cuh"
FWD_ROWS, FWD_KEYS = 128, 64    # the forward's query block and key tile (FWD_HEADER)
BWD_KEYS, BWD_ROWS = 128, 128    # dK/dV's key block, dQ's query block (BWD_HEADER)
P_TERMS = 3         # bf16 parts of the forward's p: kPTerms of FWD_HEADER
# the card's shape cut to S = 1000 (not a multiple of 64): the 7B's group of
# 7 q heads on one KV head at D = 128, three packed segments and a pad tail
S, HQ, HK, D = 1000, 7, 1, 128
LENGTHS = (300, 290, 310)
EXT_ID = 99         # the segment of the rows that extend S to splash's 1024


def segments(s, lengths):
    """int32 [1, s]: segments 1..n of ``lengths``, the rest 0 (pad)."""
    seg = np.zeros((1, s), np.int32)
    at = 0
    for i, n in enumerate(lengths):
        seg[0, at:at + n] = i + 1
        at += n
    return seg


def case(seed=0):
    """bf16 (q, qs, k, v, do, seg) made with numpy from a seed."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(1, S, h, D).astype(np.float32)).to(BF16)
                   for h in (HQ, HK, HK, HQ))
    return q, prescaled(q), k, v, do, torch.from_numpy(segments(S, LENGTHS))


def heads(x, groups):
    """[B, S, H, D] -> fp32 [B, H * groups, S, D]."""
    return x.transpose(1, 2).repeat_interleave(groups, dim=1).float()


def split_bf16(p, terms):
    """p as ``terms`` bf16 parts (in fp32), each the rounding of what the
    earlier parts left, as the forward kernel splits it."""
    parts = []
    for _ in range(terms):
        parts.append(p.to(BF16).float())
        p = p - parts[-1]
    return parts


def live_tiles(seg, r0, t0, t1, rows=TILE, keys=TILE):
    """The kernels' ``live_tiles`` (batch row 0): the ``keys``-row tiles t
    in [t0, t1) that hold an id of the block's rows [r0, r0 + rows),
    exactly when those rows hold at most two ids, else any id in their
    range."""
    ids = seg[0, r0:r0 + rows]
    lo, hi = ids.min(), ids.max()
    three = bool(((ids != lo) & (ids != hi)).any())
    out = []
    for t in range(t0, t1):
        x = seg[0, t * keys:(t + 1) * keys]
        if bool((((x >= lo) & (x <= hi)) if three else ((x == lo) | (x == hi))).any()):
            out.append(t)
    return out


def walked(seg, causal, by_keys=False, rows=BWD_ROWS, keys=TILE):
    """bool [1, 1, S, S] (queries, keys): the tile pairs the kernels walk.
    The forward (blocks of ``rows`` queries over tiles of ``keys`` keys:
    ``FWD_ROWS``, ``FWD_KEYS``) and dQ (``BWD_ROWS`` x ``TILE``): each
    query block's live key tiles up to its diagonal (all of them when not
    ``causal``); dK/dV (``by_keys``: blocks of ``rows`` keys, ``BWD_KEYS``,
    over tiles of ``keys`` queries): each key block's live query tiles from
    its diagonal on (all when not ``causal``)."""
    s = seg.shape[1]
    mask = torch.zeros((s, s), dtype=torch.bool)
    if by_keys:
        n = -(-s // keys)
        for own in range(-(-s // rows)):
            k0 = own * rows
            for other in live_tiles(seg, k0, k0 // keys if causal else 0, n, rows, keys):
                mask[other * keys:(other + 1) * keys, k0:k0 + rows] = True
        return mask[None, None]
    n_keys = -(-s // keys)
    for own in range(-(-s // rows)):
        r0 = own * rows
        end = min(n_keys, (r0 + rows - 1) // keys + 1) if causal else n_keys
        for other in live_tiles(seg, r0, 0, end, rows, keys):
            mask[r0:r0 + rows, other * keys:(other + 1) * keys] = True
    return mask[None, None]


def fwd_tiles(qs, k, v, seg, terms=P_TERMS, causal=True):
    """The forward kernel's arithmetic: (o in fp32 before its rounding, lse).
    Each block of ``FWD_ROWS`` queries takes its live ``FWD_KEYS``-key tiles
    in order (``walked``; a tile pair it does not walk takes no part), a
    running max and sum updated tile by tile. p meets V as ``terms`` bf16
    parts (``split_bf16``; 1 is K1's p.astype(v.dtype)), or as exact fp32 p
    with ``terms=None``."""
    g = qs.shape[2] // k.shape[2]
    q, kk, vv = heads(qs, 1), heads(k, g), heads(v, g)
    allowed = _allowed(seg, causal) & walked(seg, causal, rows=FWD_ROWS, keys=FWD_KEYS)
    m = torch.full(q.shape[:-1] + (1,), MASK_VALUE)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k0 in range(0, q.shape[2], FWD_KEYS):
        ok = allowed[..., k0:k0 + FWD_KEYS]
        sc = torch.where(ok, q @ kk[:, :, k0:k0 + FWD_KEYS].transpose(-1, -2),
                         torch.full((), MASK_VALUE))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(sc - m_new), torch.zeros(()))
        l = l * alpha + p.sum(-1, keepdim=True)
        vt = vv[:, :, k0:k0 + FWD_KEYS]
        acc = acc * alpha + (p @ vt if terms is None else
                             sum(part @ vt for part in split_bf16(p, terms)))
        m = m_new
    return (acc / l).transpose(1, 2), (m + torch.log(l)).squeeze(-1)


def bwd_tiles(qs, k, v, seg, o, lse, do, causal=True):
    """The backward kernels' arithmetic: (dq for qs, dk, dv) in bf16. dK/dV
    in the transposed form, walking the group's q heads and the 64-query
    tiles in the kernel's order (each tile one pass); dQ over the 64-key
    tiles; each over the tile pairs its kernel walks (``BWD_KEYS``-key
    and ``BWD_ROWS``-query blocks)."""
    b, s, hq, d = qs.shape
    hk = k.shape[2]
    g = hq // hk
    q, dot = heads(qs, 1), heads(do, 1)                    # [B, Hq, S, D]
    kk, vv = heads(k, 1), heads(v, 1)                      # [B, Hk, S, D]
    di = (o.float() * do.float()).sum(-1).transpose(1, 2)  # [B, Hq, S]
    allowed_t = (_allowed(seg, causal) & walked(seg, causal, by_keys=True, rows=BWD_KEYS)
                 ).transpose(-1, -2)                 # [B, 1, keys, queries]
    dk, dv = torch.zeros_like(kk), torch.zeros_like(vv)
    for gi in range(g):
        heads_g = [kvh * g + gi for kvh in range(hk)]
        for q0 in range(0, s, TILE):
            cols = slice(q0, q0 + TILE)
            qt, dt = q[:, heads_g, cols], dot[:, heads_g, cols]
            ok = allowed_t[..., cols]
            pt = torch.where(ok, torch.exp(kk @ qt.transpose(-1, -2) - lse[:, heads_g, None, cols]),
                             torch.zeros(()))
            dv = dv + pt.to(BF16).float() @ dt
            dst = pt * (vv @ dt.transpose(-1, -2) - di[:, heads_g, None, cols])
            dk = dk + dst.to(BF16).float() @ qt
    allowed = _allowed(seg, causal) & walked(seg, causal)
    kr, vr = kk.repeat_interleave(g, 1), vv.repeat_interleave(g, 1)
    dq = torch.zeros_like(q)
    for k0 in range(0, s, TILE):
        rows = slice(k0, k0 + TILE)
        p = torch.where(allowed[..., rows],
                        torch.exp(q @ kr[:, :, rows].transpose(-1, -2) - lse[..., None]),
                        torch.zeros(()))
        ds = p * (dot @ vr[:, :, rows].transpose(-1, -2) - di[..., None])
        dq = dq + ds.to(BF16).float() @ kr[:, :, rows]
    return tuple(x.transpose(1, 2).to(BF16) for x in (dq, dk, dv))


@pytest.fixture(scope="module")
def tiles():
    """The emulated kernels' five outputs on ``case()``."""
    _, qs, k, v, do, seg = case()
    o32, lse = fwd_tiles(qs, k, v, seg)
    o = o32.to(BF16)
    return (o, lse, *bwd_tiles(qs, k, v, seg, o, lse, do))


def jax_splash(q, k, v, do, seg, causal=True):
    """JAX ``_train_splash`` in interpret mode on the same bf16 inputs: (o,
    dq for the unscaled q, dk, dv). Splash takes S in multiples of 128, so
    the rows are extended to 1024 by rows of a segment of their own (id
    ``EXT_ID``, zero cotangent): no real query attends them, causal or
    not, and their zero cotangent adds nothing to any gradient."""
    ext = 1024 - S

    def pad(x):
        return jnp.pad(jnp.asarray(x.float().numpy()), ((0, 0), (0, ext), (0, 0), (0, 0)))

    seg_j = jnp.pad(jnp.asarray(seg.numpy()), ((0, 0), (0, ext)), constant_values=EXT_ID)
    w = pad(do)

    def f(q_, k_, v_):
        out = jattn._train_splash(q_, k_, v_, seg_j, causal, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, o), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(pad(x).astype(jnp.bfloat16) for x in (q, k, v)))
    return [torch.from_numpy(np.array(x.astype(jnp.float32))[:, :S]).to(BF16)
            for x in (o, *grads)]


def close_rows(out, ref, dtype, seg=None):
    """``kernel_check.close``; with ``seg``, on the rows of queries that
    have a key before them in their segment. The others (a query alone in
    its segment's causal prefix: one key, p = 1) have a dq of exactly 0,
    which both sides give as rounding noise of either sign, where close's
    limit is 0: they are held to at most 1e-4 of ref's rms instead."""
    if seg is None:
        return kernel_check.close(out, ref, dtype)
    ids = seg[0]
    alone = torch.ones_like(ids, dtype=torch.bool)
    alone[1:] = ids[1:] != ids[:-1]                  # the segments are runs of one id
    assert len(set(ids[alone].tolist())) == int(alone.sum())
    scale = ref.float().square().mean().sqrt().item()
    for x in (out, ref):
        assert x[:, alone].float().abs().max().item() <= 1e-4 * scale
    return kernel_check.close(out[:, ~alone], ref[:, ~alone], dtype)


@pytest.mark.parametrize("ref", ["jax_splash", "plain"])
def test_tiles_match_the_references(tiles, ref):
    """The kernels' arithmetic against JAX splash in interpret mode and
    against the plain versions, each output within ``kernel_check.close``
    in bf16 (lse, fp32, in fp32's limit). Against JAX: o, and the three
    gradients of the backward fed JAX's o, as splash's backward reads its
    own (di = rowsum(o * do) cancels in rows of few keys, where one bf16
    step of o moves dq past the limit); JAX's dq is for the unscaled q, so
    the emulation's dq for qs is scaled by d**-0.5 to meet it. Against the
    plain versions: all five outputs, each side from its own forward."""
    q, qs, k, v, do, seg = case()
    o, lse, dq, dk, dv = tiles
    if ref == "jax_splash":
        refs = jax_splash(q, k, v, do, seg)
        dq, dk, dv = bwd_tiles(qs, k, v, seg, refs[0], lse, do)
        outs = (o, (dq.float() * D ** -0.5).to(BF16), dk, dv)
        dtypes = (BF16,) * 4
    else:
        ro, rlse = train_attention_fwd_plain(qs, k, v, seg)
        outs = tiles
        refs = (ro, rlse, *train_attention_bwd_plain(qs, k, v, seg, ro, rlse, do))
        dtypes = (BF16, torch.float32, BF16, BF16, BF16)
    for i, (out, r, dt) in enumerate(zip(outs, refs, dtypes)):
        is_dq = i == len(outs) - 3
        assert close_rows(out, r, dt, seg if is_dq else None) <= 1.0


def test_split_keeps_fp32_p():
    """The kernel's three bf16 parts hold an fp32 p exactly (p = exp(x) for
    x in [-60, 0]; far below that the smallest part turns subnormal), so its
    P·V stays within 1e-5 of fp32 P·V (each row's error norm over the row's
    norm, before the output is rounded); p rounded once to bf16 (2^-9
    relative per term) does not."""
    gen = torch.Generator().manual_seed(2)
    p = torch.exp(-60 * torch.rand(1 << 16, generator=gen))
    parts = split_bf16(p, P_TERMS)
    assert torch.equal(parts[0] + parts[1] + parts[2], p)
    _, qs, k, v, _, seg = case(1)
    exact, _ = fwd_tiles(qs, k, v, seg, None)

    def row_err(terms):
        out, _ = fwd_tiles(qs, k, v, seg, terms)
        return ((out - exact).norm(dim=-1) / exact.norm(dim=-1)).max().item()

    assert row_err(P_TERMS) <= 1e-5
    assert row_err(1) >= 1e-4


@pytest.mark.parametrize("qt,kt,h", [(3, 1, 3), (8, 5, 0)])
def test_a_dropped_tile_pair_fails_every_output(tiles, qt, kt, h):
    """``kernel_check.dropped_tile`` (the plain outputs without one 64 x 64
    tile pair of one q head) fails the check of each of o, lse, dq, dk and
    dv against the kernels' arithmetic at least 5x over."""
    _, qs, k, v, do, seg = case()
    ro, rlse = train_attention_fwd_plain(qs, k, v, seg)
    rgrads = train_attention_bwd_plain(qs, k, v, seg, ro, rlse, do)
    fault = kernel_check.dropped_tile(qs, k, v, seg, do, ro, rlse, rgrads, qt, kt, h)
    for out, bad, dt in zip(tiles, fault, (BF16, torch.float32, BF16, BF16, BF16)):
        assert kernel_check.close(out, bad, dt) >= 5.0


@pytest.mark.parametrize("qt,kt,h", [(3, 1, 3), (8, 5, 0)])
def test_gradient_check_holds_the_tiles_and_fails_a_dropped_tile(tiles, qt, kt, h):
    """``kernel_check.grad_close``, the check that holds bf16 K4's
    gradients on the card: the emulated kernels' dq, dk and dv against the
    fp32 plain version (fp32 inputs, nothing rounded), with the bf16 plain
    backward on the emulation's o and lse setting the rounding allowed,
    pass it; the same gradients without one tile pair fail it at least 5x
    over."""
    _, qs, k, v, do, seg = case()
    o, lse = tiles[:2]
    ref = train_attention_bwd_plain(qs, k, v, seg, o, lse, do)
    f32 = [x.float() for x in (qs, k, v)]
    ref32 = train_attention_bwd_plain(*f32, seg, *train_attention_fwd_plain(*f32, seg),
                                      do.float())
    fault = kernel_check.dropped_tile(qs, k, v, seg, do, o, lse, ref, qt, kt, h)[2:]
    for out, r, r32, bad in zip(tiles[2:], ref, ref32, fault):
        assert kernel_check.grad_close(out, r, r32) <= 1.0
        assert kernel_check.grad_close(bad, r, r32) >= 5.0


def test_train_tiles_are_the_kernels_constants():
    """``kernel_check.TILE`` is the K4 backward kernels' streamed tile (64
    queries for dK/dV, 64 keys for dQ), ``BWD_KEYS`` and ``BWD_ROWS`` their
    key and query blocks; ``FWD_ROWS`` and ``FWD_KEYS`` the forward's query
    block and key tile, and ``P_TERMS`` its number of bf16 parts of p."""
    for header, constants in ((BWD_HEADER, (("kTrainBwdTile", TILE), ("kTrainBwdKeys", BWD_KEYS),
                                            ("kTrainBwdRows", BWD_ROWS))),
                              (FWD_HEADER, (("kTrainFwdRows", FWD_ROWS),
                                            ("kTrainFwdKeys", FWD_KEYS), ("kPTerms", P_TERMS)))):
        text = header.read_text()
        for name, value in constants:
            assert re.findall(rf"constexpr int {name} = (\d+);", text) == [str(value)]


# segment layouts beside the case's: short segments, so that a 128-row block
# holds three or more ids (the walk's range test), and ids that recur along
# the row (runs of 37 tokens cycling through 0, 1, 2)
WALK_LAYOUTS = {"packed": None, "short": (100, 20, 90, 33, 150, 60, 200, 47),
                "recurring": "runs"}


def layout(name):
    """int32 [1, S] segment ids of ``WALK_LAYOUTS[name]``."""
    kind = WALK_LAYOUTS[name]
    if kind is None:
        return case()[5]
    if kind == "runs":
        return ((torch.arange(S) // 37) % 3).to(torch.int32)[None]
    return torch.from_numpy(segments(S, kind))


@pytest.mark.parametrize("name", list(WALK_LAYOUTS))
@pytest.mark.parametrize("causal", [True, False])
def test_forward_walk_covers_what_the_masks_allow(name, causal):
    """The forward's walk (128-query blocks over 64-key tiles) reaches
    every pair the mask allows, on layouts where a block holds one, two or
    three and more ids (the range test), and skips tiles whose ids cannot
    meet the block's; in the causal form no walk passes the block's
    diagonal."""
    seg = layout(name)
    walk = walked(seg, causal, rows=FWD_ROWS, keys=FWD_KEYS)
    assert not (_allowed(seg, causal) & ~walk).any()
    if name != "recurring":                            # recurring ids meet everywhere
        assert walk.sum() < (_allowed(seg, True) if causal else torch.ones(S, S)).numel()
        assert (~_allowed(seg, causal) & ~walk).any()
    if causal:
        q = torch.arange(S)
        beyond = (q[None, :] // FWD_KEYS) > (q[:, None] // FWD_ROWS * FWD_ROWS + FWD_ROWS - 1
                                            ) // FWD_KEYS
        assert not (walk[0, 0] & beyond).any()
    ids = [seg[0, r0:r0 + FWD_ROWS] for r0 in range(0, S, FWD_ROWS)]
    if name == "short":
        assert max(len(set(x.tolist())) for x in ids) >= 3


@pytest.mark.parametrize("name", ["short", "recurring"])
def test_forward_tiles_on_other_layouts(name):
    """The forward's arithmetic on the other segment layouts (three and
    more ids a block; recurring ids) against the plain version, o within
    ``kernel_check.close`` in bf16 and lse in fp32."""
    _, qs, k, v, _, _ = case(3)
    seg = layout(name)
    o32, lse = fwd_tiles(qs, k, v, seg)
    ro, rlse = train_attention_fwd_plain(qs, k, v, seg)
    assert kernel_check.close(o32.to(BF16), ro, BF16) <= 1.0
    assert kernel_check.close(lse, rlse, torch.float32) <= 1.0


@pytest.mark.parametrize("name", list(WALK_LAYOUTS))
@pytest.mark.parametrize("causal", [True, False])
def test_backward_walks_cover_what_the_masks_allow(name, causal):
    """The backward's walks, dK/dV's (128-key blocks over 64-query tiles,
    from the block's diagonal on) and dQ's (128-query blocks over 64-key
    tiles, up to it), reach every pair the mask allows on layouts where a
    block holds one, two or three and more ids, and skip tiles whose ids
    cannot meet the block's; in the causal form dK/dV's walk starts at the
    query tile of the block's first key, and no dQ walk passes the
    block's diagonal."""
    seg = layout(name)
    by_keys = walked(seg, causal, by_keys=True, rows=BWD_KEYS)
    by_rows = walked(seg, causal, rows=BWD_ROWS)
    for walk in (by_keys, by_rows):
        assert not (_allowed(seg, causal) & ~walk).any()
        if name != "recurring":
            assert (~_allowed(seg, causal) & ~walk).any()
    if causal:
        q = torch.arange(S)
        before = (q[:, None] // TILE) < (q[None, :] // BWD_KEYS * BWD_KEYS) // TILE
        assert not (by_keys[0, 0] & before).any()
        beyond = (q[None, :] // TILE) > (q[:, None] // BWD_ROWS * BWD_ROWS + BWD_ROWS - 1) // TILE
        assert not (by_rows[0, 0] & beyond).any()


@pytest.mark.parametrize("name", ["short", "recurring"])
def test_backward_tiles_on_other_layouts(name):
    """The backward's arithmetic on the other segment layouts (three and
    more ids a block; recurring ids), fed the emulated forward's o and lse:
    dq, dk and dv within ``kernel_check.grad_close`` of the fp32 plain
    version, the bf16 plain backward on the same o and lse setting the
    rounding allowed."""
    _, qs, k, v, do, _ = case(3)
    seg = layout(name)
    o32, lse = fwd_tiles(qs, k, v, seg)
    o = o32.to(BF16)
    ref = train_attention_bwd_plain(qs, k, v, seg, o, lse, do)
    f32 = [x.float() for x in (qs, k, v)]
    ref32 = train_attention_bwd_plain(*f32, seg, *train_attention_fwd_plain(*f32, seg),
                                      do.float())
    for out, r, r32 in zip(bwd_tiles(qs, k, v, seg, o, lse, do), ref, ref32):
        assert kernel_check.grad_close(out, r, r32) <= 1.0


@pytest.fixture(scope="module")
def full_tiles():
    """The emulated kernels' five outputs on ``case()`` in the non-causal
    form."""
    _, qs, k, v, do, seg = case()
    o32, lse = fwd_tiles(qs, k, v, seg, causal=False)
    o = o32.to(BF16)
    return (o, lse, *bwd_tiles(qs, k, v, seg, o, lse, do, causal=False))


def test_walks_cover_the_live_tiles():
    """The causal walks stop at (forward, dQ) or start from (dK/dV) the
    diagonal; the non-causal walks reach every tile that shares an id with
    the block's own, so every pair the non-causal mask allows is walked."""
    seg = case()[5]
    full = _allowed(seg, False)
    assert not (full & ~walked(seg, False)).any()
    assert not (full & ~walked(seg, False, by_keys=True, rows=BWD_KEYS)).any()
    assert not (_allowed(seg) & ~walked(seg, True)).any()
    assert not (_allowed(seg) & ~walked(seg, True, by_keys=True, rows=BWD_KEYS)).any()
    assert (full & ~walked(seg, True)).any()
    assert walked(seg, False).sum() < S * S           # segments that cannot meet are skipped


@pytest.mark.parametrize("ref", ["jax_splash", "plain"])
def test_noncausal_tiles_match_the_references(full_tiles, ref):
    """The non-causal walk's arithmetic against JAX splash with a
    ``FullMask`` in interpret mode and against the non-causal plain
    versions, as ``test_tiles_match_the_references`` holds the causal one
    (no query is alone in its segment here, so dq is held on every row)."""
    q, qs, k, v, do, seg = case()
    o, lse, dq, dk, dv = full_tiles
    if ref == "jax_splash":
        refs = jax_splash(q, k, v, do, seg, causal=False)
        dq, dk, dv = bwd_tiles(qs, k, v, seg, refs[0], lse, do, causal=False)
        outs, dtypes = (o, (dq.float() * D ** -0.5).to(BF16), dk, dv), (BF16,) * 4
    else:
        ro, rlse = train_attention_fwd_plain(qs, k, v, seg, causal=False)
        outs = full_tiles
        refs = (ro, rlse, *train_attention_bwd_plain(qs, k, v, seg, ro, rlse, do, causal=False))
        dtypes = (BF16, torch.float32, BF16, BF16, BF16)
    for out, r, dt in zip(outs, refs, dtypes):
        assert kernel_check.close(out, r, dt) <= 1.0


def test_causal_walk_fails_the_noncausal_tiles(full_tiles):
    """``kernel_check.causal_walk``, the non-causal outputs as kernels that
    kept the causal walk and mask would give them, fails the check of each
    of o, lse, dq, dk and dv against the non-causal emulation at least 5x
    over; and the emulation run with the causal walk is that fault."""
    _, qs, k, v, do, seg = case()
    o, lse = full_tiles[:2]
    fault = kernel_check.causal_walk(qs, k, v, seg, do, o, lse)
    for out, bad, dt in zip(full_tiles, fault, (BF16, torch.float32, BF16, BF16, BF16)):
        assert kernel_check.close(bad, out, dt) >= 5.0
    causal_o, causal_lse = fwd_tiles(qs, k, v, seg)
    assert kernel_check.close(causal_o.to(BF16), fault[0], BF16) <= 1.0
    assert kernel_check.close(causal_lse, fault[1], torch.float32) <= 1.0

"""bf16 K1's and K3's tiling (``csrc/wgmma_attention.cuh``) in PyTorch.

The test modules hold these emulations to the JAX kernels (fp32) and use
them as the kernels' arithmetic in bf16. They go through the kernels' steps
in their order, with the constants and the grid of ``ops/flash_attention.py``
(``prefill_plan``, ``prefill_span``): a tile of 128 rows; an online softmax
over 64-key tiles in log2 units (exp2, masked scores at finfo.min), ``l``
summed before p is rounded to v's dtype, O rescaled by the new max; output
normalised after P V, 0 for a row that saw no valid key.

  * ``prefill_tiles``: K1. A block serves one KV head: row r of a tile is
    query r // G, head r % G of the group, ``128 // G`` whole queries a
    tile. Each tile's keys run up to its causal frontier in ``nsplit``
    splits of ``per`` key tiles; a split walks its tiles from its own
    running max; a tile with one live split (or none: one masked tile)
    normalises, one with more merges the splits' (O, max, sum). Keys past
    the cache (TMA's zero fill) are zeros, and so are V's rows at or past
    the row's limit (the kernel clears them before P V).
  * ``vit_tiles``: K3 over segment bounds. A tile is 128 rows from its
    segment's first row; its key tiles read whatever rows lie there (the
    next segment's, zeros past N), masked past the segment's end; query
    rows past it are computed and never stored. With ``tail`` the scores
    of D = 80 are the sum of a 64-column and a 16-column product, as the
    kernel's 4 + 1 k-steps; without, D is zero-padded to 128.
"""

import torch

from livecc_tpu_torch.ops.flash_attention import (PREFILL_KEYS, PREFILL_ROWS, prefill_plan,
                                                  prefill_span)

NEG = float(torch.finfo(torch.float32).min)
LOG2E = 1.4426950408889634


def walk(qr, keys, vals, klim, key0, tiles, scale, vdtype, tail=False):
    """One block's walk: fp32 rows ``qr`` [..., R, D] against the key tiles
    ``key0 .. key0 + tiles - 1`` of ``keys`` / ``vals`` [..., rows, D], row
    r's keys below ``klim[r]``. Returns (O, max, sum) unnormalised,
    [..., R, D], [..., R], [..., R]."""
    d = qr.shape[-1]
    m = torch.full(qr.shape[:-1], NEG)
    l = torch.zeros(qr.shape[:-1])
    acc = torch.zeros(qr.shape[:-1] + vals.shape[-1:])
    for t in range(key0, key0 + tiles):
        cols = slice(t * PREFILL_KEYS, (t + 1) * PREFILL_KEYS)
        kt, vt = keys[..., cols, :], vals[..., cols, :]
        if tail and d == 80:           # the kernel's 64-column chunk, then its 16-column tail
            s = qr[..., :64] @ kt[..., :64].transpose(-1, -2) + (
                qr[..., 64:] @ kt[..., 64:].transpose(-1, -2))
        else:
            s = qr @ kt.transpose(-1, -2)
        ok = torch.arange(cols.start, cols.stop)[None, :] < klim[:, None]
        s = torch.where(ok, s * (scale * LOG2E), torch.full((), NEG))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s - m_new[..., None]), torch.zeros(()))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(vdtype).float() @ vt
        m = m_new
    return acc, m, l


def merge(parts):
    """sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s over the splits whose
    sum is positive, 0 where none is."""
    acc = torch.stack([p[0] for p in parts])
    m = torch.stack([p[1] for p in parts])
    l = torch.stack([p[2] for p in parts])
    valid = l > 0
    big = torch.where(valid, m, torch.full((), NEG)).amax(0)
    w = torch.where(valid, torch.exp2(torch.where(valid, m, big) - big), torch.zeros(()))
    den = (w * l).sum(0)
    o = (w[..., None] * acc).sum(0)
    return o / torch.where(den > 0, den, torch.ones(()))[:, None]


def prefill_tiles(q, k, v, offset, kv_limit, stats=None):
    """K1 on q [B, Hq, Sq, D] and a one-layer cache k, v [B, Hk, Smax, D];
    ``offset`` / ``kv_limit`` sequences of B ints. Appends (batch row, KV
    head, tile, live splits) to ``stats`` where given. Returns
    [B, Hq, Sq, D] in q's dtype."""
    b, hq, sq, d = q.shape
    hk, smax = k.shape[1], k.shape[2]
    g = hq // hk
    qt, tiles, nsplit = prefill_plan(b, hq, hk, sq)
    pad = -(-smax // PREFILL_KEYS) * PREFILL_KEYS - smax
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))       # TMA's zeros past Smax
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    out = torch.zeros(b, hq, sq, d)
    for bi in range(b):
        lim = min(int(kv_limit[bi]), smax)
        off = int(offset[bi])
        vrows = torch.where(torch.arange(vf.shape[2])[:, None] < lim, vf[bi], torch.zeros(()))
        for kvh in range(hk):
            for t in range(tiles):
                i0, nq = t * qt, min(qt, sq - t * qt)
                rows = q[bi, kvh * g:(kvh + 1) * g, i0:i0 + nq].float().transpose(0, 1)
                qr = rows.reshape(nq * g, d)                        # row = query * G + head
                klim = torch.minimum(torch.tensor(lim),
                                     off + i0 + torch.arange(nq * g) // g + 1)
                n, per, live = prefill_span(min(lim, off + i0 + nq), nsplit)
                parts = [walk(qr, kf[bi, kvh], vrows[kvh], klim, s * per,
                              max(min(n - s * per, per), 1), d ** -0.5, v.dtype)
                         for s in range(max(live, 1))]
                if stats is not None:
                    stats.append((bi, kvh, t, live))
                if live <= 1:
                    acc, _, l = parts[0]
                    o = acc / torch.where(l > 0, l, torch.ones(()))[:, None]
                else:
                    o = merge(parts)
                out[bi, kvh * g:(kvh + 1) * g, i0:i0 + nq] = o.reshape(nq, g, d).transpose(0, 1)
    return out.to(q.dtype)


def vit_tiles(q, k, v, cu_seqlens, tail=True):
    """K3 on q, k, v [N, H, D] over the bounds ``cu_seqlens``. Returns
    [N, H, D] in q's dtype."""
    n_rows, h, d = q.shape
    bounds = [int(x) for x in cu_seqlens]
    longest = max(e - a for a, e in zip(bounds[:-1], bounds[1:]))
    span = -(-longest // PREFILL_ROWS) * PREFILL_ROWS + PREFILL_KEYS
    # rows past N read TMA's zeros
    qf, kf, vf = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, span)) for x in (q, k, v))
    if not tail and d == 80:                                        # rounded up to 128
        qf, kf, vf = (torch.nn.functional.pad(x, (0, 48)) for x in (qf, kf, vf))
    out = torch.full((n_rows, h, d), float("nan"))
    for a, e in zip(bounds[:-1], bounds[1:]):
        length = e - a
        keys, vals = kf[a:].transpose(0, 1), vf[a:].transpose(0, 1)    # [H, rows, D]
        for q0 in range(0, length, PREFILL_ROWS):
            # rows past the segment's end are the next rows, computed and not stored
            qr = qf[a + q0:a + q0 + PREFILL_ROWS].transpose(0, 1)
            acc, _, l = walk(qr, keys, vals, torch.full((PREFILL_ROWS,), length), 0,
                             -(-length // PREFILL_KEYS), d ** -0.5, v.dtype, tail)
            o = acc / torch.where(l > 0, l, torch.ones(()))[..., None]
            rows = min(PREFILL_ROWS, length - q0)                       # never past the segment
            out[a + q0:a + q0 + rows] = o[:, :rows, :d].transpose(0, 1)
    return out.to(q.dtype)

"""K2 / K2-int8's one-launch decode at its span, on the CPU.

The CUDA kernel (``csrc/decode_attention.cuh``) splits each row's keys into
spans of ``DECODE_SPLIT`` keys; every live split block writes its partials
(m, l, acc), takes a ticket from the row's arrival counter, and the block
that takes the last ticket merges the row's partials in split order. Here:

  * the split plain version at ``DECODE_SPLIT`` composed with the merge
    plain version against JAX ``flash_decode`` in interpret mode at its
    own ``bk = 512``, with limits on and around the span's edges;
  * an emulation of the kernel's ticket and merge (``last_block_merge``):
    whatever order the partials arrive in, the output's bits are the same,
    where a merge in arrival order would not be;
  * NaN and Inf in the cache past each row's kv_limit, and past Smax in
    the buffer the cache is a view of, leave the output bit for bit as it
    is, bf16 and int8 (the plain versions read V and v_scale there as
    zeros, as the kernel never reads them);
  * ``chip_smoke.ptxas_report`` fails a build where the decode kernel
    spills.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from livecc_tpu.models.qwen2_vl.text import quantize_kv as jax_quantize_kv
from livecc_tpu.ops.pallas.attention import flash_decode as jax_flash_decode

from livecc_tpu_torch.models.qwen2_vl.text import quantize_kv
from livecc_tpu_torch.ops.flash_attention import (
    DECODE_SPLIT, flash_decode, flash_decode_merge_plain, flash_decode_plain,
    flash_decode_split_plain)
from livecc_tpu_torch.tools import kernel_check
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.from_numpy
SPAN = DECODE_SPLIT
SMAX, D = 4 * SPAN, 32              # a whole number of JAX's 512-key blocks
# per-row limits in one batch: on and around the span's edges, none, all
LIMITS = [SPAN + 1, 0, SMAX, 1, SPAN, SPAN - 1, 2 * SPAN + 63]
INT8_TOL = dict(atol=3e-5, rtol=1e-4)     # the JAX package's int8 kernel tolerance


def cache(rng, shape, kind):
    """(JAX arrays, torch tensors) of K or V: (codes, lane-major scales) for
    int8 (the JAX quantizer, so both see the same cache), else (x, None)."""
    x = rng.randn(*shape).astype(np.float32)
    if kind != "int8":
        return (jnp.asarray(x), None), (T(x), None)
    codes, scale = jax_quantize_kv(jnp.asarray(x))
    scale = jnp.swapaxes(scale, -1, -2)
    return (codes, scale), (T(np.array(codes)), T(np.array(scale, np.float32)).bfloat16())


@pytest.mark.parametrize("hq,hk", [(7, 1), (4, 2)])           # G = 7 (the 7B's) and G = 2
@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_span_split_merge_matches_jax(kind, hq, hk):
    rng = np.random.RandomState(60 + hq + (kind == "int8"))
    b = len(LIMITS)
    (kj, ksj), (kp, ksp) = cache(rng, (b, hk, SMAX, D), kind)
    (vj, vsj), (vp, vsp) = cache(rng, (b, hk, SMAX, D), kind)
    q = rng.randn(b, hq, 1, D).astype(np.float32)
    lim = np.asarray(LIMITS, np.int32)
    ref = jax_flash_decode(jnp.asarray(q), kj, vj, jnp.asarray(lim), k_scale=ksj, v_scale=vsj,
                           bk=512, interpret=True)
    m, l, acc = flash_decode_split_plain(T(q), kp, vp, T(lim), SPAN, ksp, vsp)
    assert m.shape == (b, hq, SMAX // SPAN)
    out = flash_decode_merge_plain(m, l, acc, torch.float32)
    tol = INT8_TOL if kind == "int8" else dict(atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)
    assert not out[LIMITS.index(0)].any()
    # a row's live splits are the ceil(limit / SPAN) first: they hold l >= 1
    live = (torch.arange(SMAX // SPAN) * SPAN)[None, :] < T(lim)[:, None]
    assert bool((l >= 1)[live[:, None].expand_as(l)].all())
    assert bool((l[~live[:, None].expand_as(l)] == 0).all())


def last_block_merge(m, l, acc, arrival, out_dtype, in_split_order=True):
    """The kernel's one-launch merge for one row: the live splits' blocks
    write their partials (m, l ``[G, S]``, acc ``[G, S, D]``) into a
    workspace in ``arrival`` order, each then takes a ticket; the block
    that takes the last one merges, reading the workspace in split order
    (or, ``in_split_order=False``, in the order the partials arrived) as
    the kernel's arithmetic does: M = max m, w_s = exp(m_s - M), L = sum_s
    w_s l_s in 32 lanes' strided sums reduced by a butterfly, o = sum_s
    w_s acc_s one split after the other in fp32, o / L. ``[G, D]``."""
    g, nv = l.shape
    ws, counter, last = {}, 0, None
    for s in arrival:
        ws[s] = (m[:, s], l[:, s], acc[:, s])
        ticket, counter = counter, counter + 1          # atomicAdd
        if ticket == nv - 1:
            last = s
    assert last == arrival[-1] and counter == nv
    order = range(nv) if in_split_order else arrival
    big = torch.stack([ws[s][0] for s in range(nv)], dim=-1).amax(dim=-1)
    w = {s: torch.exp(ws[s][0] - big) for s in order}
    lanes = [torch.zeros(g) for _ in range(32)]
    for i, s in enumerate(order):
        lanes[i % 32] = lanes[i % 32] + w[s] * ws[s][1]
    step = 16
    while step:
        lanes = [lanes[j] + lanes[j ^ step] for j in range(32)]
        step //= 2
    o = torch.zeros(acc.shape[0], acc.shape[2])
    for s in order:
        o = o + w[s][:, None] * ws[s][2]
    return (o / lanes[0][:, None]).to(out_dtype)


def test_merge_in_split_order_is_bit_equal_whatever_the_arrival():
    """Twenty arrival orders of a row's 16 live splits (the 7B's G = 7 at
    D = 128, 8192 keys): the merge in split order gives one set of bits,
    within ``close`` of the plain merge; in arrival order the bits move."""
    gen = torch.Generator().manual_seed(70)
    g, d, smax = 7, 128, 16 * SPAN
    q = torch.randn((1, g, 1, d), generator=gen).bfloat16()
    k, v = (torch.randn((1, 1, smax, d), generator=gen).bfloat16() for _ in range(2))
    lim = torch.tensor([smax], dtype=torch.int32)
    m, l, acc = flash_decode_split_plain(q, k, v, lim, SPAN)
    m, l, acc = m[0], l[0], acc[0]
    nv = l.shape[-1]
    ref = flash_decode_merge_plain(m[None], l[None], acc[None], torch.float32)[0, :, 0]
    perms = [torch.randperm(nv, generator=gen).tolist() for _ in range(20)]
    outs = [last_block_merge(m, l, acc, p, torch.float32) for p in perms]
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert kernel_check.close(outs[0], ref, torch.float32) <= 1.0
    moved = [last_block_merge(m, l, acc, p, torch.float32, in_split_order=False) for p in perms]
    assert not all(torch.equal(o, moved[0]) for o in moved)


def poison(x, limits, fill, pos_dim):
    """A copy of ``x`` with the positions (dim ``pos_dim``) at or past each
    batch row's limit set to ``fill``."""
    y = x.clone()
    for i, lim in enumerate(limits):
        y[i].narrow(pos_dim - 1, lim, x.shape[pos_dim] - lim).fill_(fill)
    return y


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_nan_past_kv_limit_leaves_the_output(kind):
    """NaN and Inf past each row's kv_limit, and past Smax in the buffer the
    cache is a view of (Smax = 1000 ends inside a 64-key tile), leave the
    decode output of ``flash_decode`` (the plain version on the CPU) and of
    the split and merge plain versions bit for bit as it is."""
    gen = torch.Generator().manual_seed(80)
    b, hq, hk, d, smax, rows = 5, 14, 2, 64, 1000, 1024
    limits = [1, 777, smax, SPAN + 1, 0]
    lim = torch.tensor(limits, dtype=torch.int32)
    q = torch.randn((b, hq, 1, d), generator=gen).bfloat16()
    kv = [torch.randn((b, hk, rows, d), generator=gen).bfloat16() for _ in range(2)]
    if kind == "int8":
        (k, ks), (v, vs) = (quantize_kv(x) for x in kv)
        ks, vs = (s.transpose(-1, -2).contiguous() for s in (ks, vs))
        clean = (k, v, ks, vs)
        bad = (poison(k, limits, 127, 2), poison(v, limits, -128, 2),
               poison(ks, limits, float("nan"), 3), poison(vs, limits, float("inf"), 3))
    else:
        clean = (*kv, None, None)
        bad = (poison(kv[0], limits, float("nan"), 2), poison(kv[1], limits, float("inf"), 2),
               None, None)
    view = lambda t, dim: None if t is None else t.narrow(dim, 0, smax)   # noqa: E731
    clean = tuple(view(t, 3 if i > 1 else 2) for i, t in enumerate(clean))
    bad = tuple(view(t, 3 if i > 1 else 2) for i, t in enumerate(bad))
    outs = []
    for kvs in (clean, bad):
        one = flash_decode(q, kvs[0], kvs[1], lim, k_scale=kvs[2], v_scale=kvs[3])
        parts = flash_decode_split_plain(q, *kvs[:2], lim, SPAN, *kvs[2:])
        outs.append((one, flash_decode_merge_plain(*parts, q.dtype)))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert bool(torch.isfinite(outs[1][0].float()).all()) and not outs[1][0][4].any()
    ref = flash_decode_plain(q, *clean[:2], lim, *clean[2:])
    assert kernel_check.close(outs[0][1], ref, torch.bfloat16) <= 1.0


def test_ptxas_report_fails_a_decode_spill():
    """The smoke's build check: a decode kernel instance that spills is a
    fault; one that does not is only logged."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    name = ("_ZN6livecc53_GLOBAL__N__5bb40d57_20_flash_decode_int8_cu_7deb1c6f18"
            "decode_ring_kernelIfLb1ELi8EEEvNS0_12DecodeParamsE")
    log = (f"ptxas info    : Function properties for {name}\n"
           "    16 bytes stack frame, {0} bytes spill stores, {1} bytes spill loads\n"
           "ptxas info    : Used 96 registers, used 2 barriers, 256 bytes smem\n")
    lines, faults = chip_smoke.ptxas_report(log.format(16, 20))
    assert any("decode_ring_kernel" in line for line in lines) and len(faults) == 1
    lines, faults = chip_smoke.ptxas_report(log.format(0, 0))
    assert any("Used 96 registers" in line for line in lines) and not faults

"""K4, the port's training attention, against the JAX package's (fp32, CPU).

``train_flash_attention`` runs its plain version for CPU tensors through the
same ``autograd.Function`` as the kernels (plain forward, plain backward).
It is held to JAX ``_train_splash`` run in interpret mode (the Pallas
splash kernels on the CPU), and to JAX ``mha`` with the packed mask of
``text.py:256-267`` (the JAX CPU path).

Pad rows: splash and ``mha`` disagree on pad queries (splash: pads attend
pads; ``mha``: pads attend the valid keys, or nothing with segment ids).
Against ``mha`` the outputs are compared on valid rows only, and the
gradients through a loss on valid rows only, which both agree on: pads are
right-padded and never attended by a valid query.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livecc_tpu.ops import attention as jattn

from livecc_tpu_torch.ops import attention as pattn
from livecc_tpu_torch.ops.train_attention import (
    TrainAttention, train_attention_bwd_plain, train_attention_fwd_plain)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.from_numpy


def inputs(seed, b, s, hq, hk, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, hq, d).astype(np.float32)
    k = rng.randn(b, s, hk, d).astype(np.float32)
    v = rng.randn(b, s, hk, d).astype(np.float32)
    w = rng.randn(b, s, hq, d).astype(np.float32)       # loss weights: sum(o * w)
    return q, k, v, w


def segments(b, s, lengths):
    """int32 [b, s]: segments 1..n of the given lengths, then 0 (pad)."""
    seg = np.zeros((b, s), np.int32)
    for row in range(b):
        at = 0
        for i, n in enumerate(lengths):
            seg[row, at:at + n] = i + 1
            at += n
    return seg


def port_value_and_grads(q, k, v, w, mask, valid=None, impl=None):
    qt, kt, vt = (T(x).requires_grad_() for x in (q, k, v))
    o = pattn.train_flash_attention(qt, kt, vt, None if mask is None else T(mask), impl=impl)
    wt = T(w) if valid is None else T(w * valid[..., None, None])
    (o * wt).sum().backward()
    return o.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


@pytest.mark.parametrize("mask_kind", ["segments", "bool"])
def test_matches_jax_splash_interpret(mask_kind):
    """fp32, B=1, S=256, Hq=4, Hk=2, D=32: outputs and all three grads
    against JAX's Pallas splash kernels in interpret mode (rows in full)."""
    b, s, hq, hk, d = 1, 256, 4, 2, 32
    q, k, v, w = inputs(0, b, s, hq, hk, d)
    if mask_kind == "segments":
        mask = segments(b, s, [100, 90])                  # {1, 2, 0}
    else:
        mask = np.arange(s)[None, :] < 200                # bool validity
    o, grads = port_value_and_grads(q, k, v, w, mask)

    def f(q_, k_, v_):
        out = jattn._train_splash(q_, k_, v_, jnp.asarray(mask), True, interpret=True)
        return jnp.sum(out * w), out

    (_, jo), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(o, np.asarray(jo), atol=1e-5, rtol=0)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, np.asarray(jg), atol=1e-4, rtol=1e-4)


def jax_mha_packed(q, k, v, mask):
    """JAX's CPU training path: ``mha`` with causal & (bool mask | segments)."""
    s = q.shape[1]
    m = jattn.causal_mask(s)[None, None]
    mask = jnp.asarray(mask)
    if mask.dtype == jnp.bool_:
        m = m & mask[:, None, None, :]
    else:
        m = m & (mask[:, None, :, None] == mask[:, None, None, :]) & (mask > 0)[:, None, None, :]
    return jattn.mha(q, k, v, mask=m)


@pytest.mark.parametrize("case", ["bool", "segments", "no_mask", "mha_heads", "flash_impl"])
def test_matches_jax_mha_on_valid_rows(case):
    """Outputs on valid rows, and grads of a valid-rows loss, at 1e-5."""
    b, s, hq, hk, d = 2, 70, 6, 2, 16
    if case == "mha_heads":
        hk = hq
    q, k, v, w = inputs(1, b, s, hq, hk, d)
    if case in ("segments", "flash_impl"):
        mask = segments(b, s, [30, 25])
        valid = mask > 0
    elif case == "bool":
        mask = np.stack([np.arange(s) < 61, np.arange(s) < 44])
        valid = mask
    else:
        mask, valid = None, np.ones((b, s), bool)
    impl = "flash" if case == "flash_impl" else None
    o, grads = port_value_and_grads(q, k, v, w, mask, valid=valid, impl=impl)

    def f(q_, k_, v_):
        if mask is None:
            out = jattn.mha(q_, k_, v_, mask=jattn.causal_mask(s)[None, None])
        else:
            out = jax_mha_packed(q_, k_, v_, mask)
        return jnp.sum(out * (w * valid[..., None, None])), out

    (_, jo), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(o[valid], np.asarray(jo)[valid], atol=1e-5, rtol=0)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, np.asarray(jg), atol=1e-5, rtol=0)


@pytest.mark.parametrize("hk", [1, 2])
def test_explicit_backward_matches_autograd_of_plain(hk):
    """The Function's explicit splash backward (the kernels' plain version)
    equals autograd through the plain forward, fp32, GQA groups of 4 and 2."""
    b, s, hq, d = 2, 40, 4, 8
    q, k, v, w = inputs(2, b, s, hq, hk, d)
    mask = T(segments(b, s, [17, 15]))
    qs = T(q) * d ** -0.5
    args = [x.clone().requires_grad_() for x in (qs, T(k), T(v))]
    (TrainAttention.apply(*args, mask) * T(w)).sum().backward()
    ref = [x.clone().requires_grad_() for x in (qs, T(k), T(v))]
    (train_attention_fwd_plain(*ref, mask)[0] * T(w)).sum().backward()
    for a, r in zip(args, ref):
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(), atol=1e-5, rtol=1e-5)


def test_plain_backward_rounds_like_the_kernel_in_bf16():
    """bf16 operands: the plain backward rounds p and ds to bf16 before the
    products, as the kernel does, and stays within bf16 distance of the fp32
    backward on the same inputs."""
    b, s, hq, hk, d = 1, 48, 2, 1, 16
    q, k, v, w = inputs(3, b, s, hq, hk, d)
    seg = T(segments(b, s, [48]))
    qs, kk, vv, do = (T(x).bfloat16() for x in (q * d ** -0.5, k, v, w))
    o, lse = train_attention_fwd_plain(qs, kk, vv, seg)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    grads = train_attention_bwd_plain(qs, kk, vv, seg, o, lse, do)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    ref = train_attention_bwd_plain(qs.float(), kk.float(), vv.float(), seg, o.float(), lse,
                                    do.float())
    for g, r in zip(grads, ref):
        scale = r.abs().max().item()
        err = (g.float() - r).abs().max().item()
        assert 0 < err <= 2e-2 * scale, (err, scale)


def test_pad_rows_attend_pads_only():
    """Splash semantics: a pad query (id 0) attends only pad keys, so
    changing the valid tokens leaves a pad row's output unchanged."""
    b, s, hq, hk, d = 1, 24, 2, 2, 8
    q, k, v, _ = inputs(4, b, s, hq, hk, d)
    mask = T(np.arange(s)[None, :] < 15)
    out1 = pattn.train_attention_plain(T(q), T(k), T(v), mask)
    k2, v2 = k.copy(), v.copy()
    k2[:, :15] += 1.0
    v2[:, :15] -= 2.0
    out2 = pattn.train_attention_plain(T(q), T(k2), T(v2), mask)
    np.testing.assert_array_equal(out1[:, 15:].numpy(), out2[:, 15:].numpy())
    assert not torch.equal(out1[:, :15], out2[:, :15])


def test_wrapper_rejects_unknown_impl_and_device():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        pattn.train_flash_attention(x, x, x, impl="ring")
    m = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(RuntimeError):
        pattn.train_flash_attention(m, m, m)


def test_only_causal_training_attention_is_served():
    """JAX's signature keeps ``causal``; every training caller passes True.
    ``causal=False`` is served too, as splash's ``FullMask`` form (the
    segments alone): it differs from the causal form where a later key of
    the segment is attended."""
    q, k, v, _ = inputs(5, 1, 12, 2, 1, 8)
    full = pattn.train_flash_attention(T(q), T(k), T(v), causal=False)
    causal = pattn.train_flash_attention(T(q), T(k), T(v), causal=True)
    assert full.shape == causal.shape == q.shape
    np.testing.assert_allclose(full[:, -1].numpy(), causal[:, -1].numpy(), atol=1e-6)
    assert not torch.allclose(full[:, :-1], causal[:, :-1])


@pytest.mark.parametrize("mask_kind", ["segments", "bool"])
def test_noncausal_matches_jax_splash_interpret(mask_kind):
    """K4's non-causal form (splash ``FullMask`` with segment ids): the
    plain forward and its vjp through ``train_flash_attention(causal=False)``
    against JAX ``_train_splash(causal=False, interpret=True)``, fp32,
    packed rows with a pad tail, every row."""
    b, s, hq, hk, d = 1, 256, 4, 2, 32
    q, k, v, w = inputs(6, b, s, hq, hk, d)
    mask = segments(b, s, [100, 90]) if mask_kind == "segments" else np.arange(s)[None] < 200
    qt, kt, vt = (T(x).requires_grad_() for x in (q, k, v))
    o = pattn.train_flash_attention(qt, kt, vt, T(mask), causal=False)
    (o * T(w)).sum().backward()

    def f(q_, k_, v_):
        out = jattn._train_splash(q_, k_, v_, jnp.asarray(mask), False, interpret=True)
        return jnp.sum(out * w), out

    (_, jo), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    for g, jg in zip((qt, kt, vt), jgrads):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(jg), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("explicit", [False, True])
def test_noncausal_matches_jax_mha_segment_mask(explicit):
    """The non-causal plain forward and vjp against JAX ``mha`` with the
    segment mask alone (pads attend pads, as in splash), fp32, GQA, two rows
    packed differently with pad tails; through the autograd ``Function``
    (``explicit``: the plain backward ``train_attention_bwd_plain``) or
    through autograd of the plain forward."""
    b, s, hq, hk, d = 2, 70, 6, 2, 16
    q, k, v, w = inputs(7, b, s, hq, hk, d)
    seg = segments(b, s, [30, 25])
    seg[1] = segments(1, s, [10, 40, 12])[0]
    qs = T(q) * d ** -0.5
    args = [x.clone().requires_grad_() for x in (qs, T(k), T(v))]
    if explicit:
        o = TrainAttention.apply(*args, T(seg), False)
    else:
        o = train_attention_fwd_plain(*args, T(seg), causal=False)[0]
    (o * T(w)).sum().backward()

    def f(q_, k_, v_):
        m = jnp.asarray(seg)[:, None, :, None] == jnp.asarray(seg)[:, None, None, :]
        out = jattn.mha(q_, k_, v_, mask=m)
        return jnp.sum(out * w), out

    (_, jo), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    grads = (args[0].grad * d ** -0.5, args[1].grad, args[2].grad)   # dq for the unscaled q
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_backward_equals_the_plain_one(dtype):
    """``kernel_check.train_attention_bwd_blocked`` (query rows in blocks of
    64, dk and dv summed over the blocks in fp32; the reference of K4's
    backward where the whole plain version does not fit) against
    ``train_attention_bwd_plain`` on packed segments with a pad tail: dq
    bit-equal, dk and dv within fp32's summation order (1e-5), or one bf16
    step (rtol 2**-7) where a sum rounds the other way. In bf16, as the
    reference of ``grad_close`` against the fp32 plain version: the plain
    version passes it, a dropped tile pair (``dropped_tile``) fails it."""
    from livecc_tpu_torch.tools import kernel_check

    gen = torch.Generator().manual_seed(0)
    s, (hq, hk, d) = 300, (4, 2, 16)
    qs, k, v, do = (torch.randn((1, s, h, d), generator=gen).to(dtype) for h in (hq, hk, hk, hq))
    qs = (qs.float() * d ** -0.5).to(dtype)
    seg = T(segments(1, s, [120, 110]))
    o, lse = train_attention_fwd_plain(qs, k, v, seg)
    ref = train_attention_bwd_plain(qs, k, v, seg, o, lse, do)
    blk = kernel_check.train_attention_bwd_blocked(qs, k, v, seg, o, lse, do, rows=64)
    assert torch.equal(blk[0], ref[0])
    for b, r in zip(blk[1:], ref[1:]):
        assert b.dtype == r.dtype
        if dtype == torch.float32:
            torch.testing.assert_close(b, r, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(b.float(), r.float(), rtol=2 ** -7, atol=1e-6)
    if dtype == torch.bfloat16:
        f32 = [x.float() for x in (qs, k, v)]
        r32 = train_attention_bwd_plain(*f32, seg, *train_attention_fwd_plain(*f32, seg),
                                        do.float())
        bad = kernel_check.dropped_tile(qs, k, v, seg, do, o, lse, blk, 1, 0, 3)[2:]
        for b, r, x, fault in zip(blk, ref, r32, bad):
            assert kernel_check.grad_close(r, b, x) <= 1.0
            assert kernel_check.grad_close(fault, b, x) > 1.0

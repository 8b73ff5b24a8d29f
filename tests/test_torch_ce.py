"""The port's chunked cross-entropy against JAX ``ops/chunked_ce.py`` (CPU).

Same numpy inputs through both: the summed loss, the count, and both
gradients (hidden and the ``[H, V]`` kernel), for ``impl`` scan and fused,
through the padding leg (S % chunk != 0), an all-masked chunk and the
frozen-kernel path. fp32 at 1e-5; the bf16-logit drift bound is the JAX
suite's (``tests/test_train_step.py:195-224``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livecc_tpu.ops import chunked_ce as jce

from livecc_tpu_torch.ops import chunked_ce as pce
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.from_numpy


def problem(seed, b=2, s=50, h=64, v=512, masked_prefix=None):
    rng = np.random.RandomState(seed)
    hidden = rng.randn(b, s, h).astype(np.float32)
    kernel = (rng.randn(h, v) / np.sqrt(h)).astype(np.float32)
    labels = rng.randint(0, v, size=(b, s)).astype(np.int32)
    if masked_prefix is not None:
        labels[0, :masked_prefix] = -100
    labels[1, ::7] = -100
    return hidden, kernel, labels


def port(hidden, kernel, labels, impl, kernel_grad=True, chunk=16, logit_dtype=None):
    """(mean loss, count, d hidden, d kernel) from the port; the kernel is
    the transposed view of a [V, H] weight, as the model passes it."""
    hid = T(hidden).requires_grad_()
    weight = T(np.ascontiguousarray(kernel.T)).requires_grad_()
    loss, count = pce.chunked_cross_entropy(hid, weight.t(), T(labels), chunk_size=chunk,
                                            impl=impl, kernel_grad=kernel_grad,
                                            logit_dtype=logit_dtype)
    mean = loss / torch.clamp(count, min=1)
    mean.backward()
    gk = None if weight.grad is None else weight.grad.t().numpy()
    return float(mean.detach()), int(count), hid.grad.numpy(), gk


def jax_ref(hidden, kernel, labels, impl="scan", kernel_grad=True, chunk=16, logit_dtype=None):
    def mean(h, k):
        loss, count = jce.chunked_cross_entropy(h, k, jnp.asarray(labels), chunk_size=chunk,
                                                impl=impl, kernel_grad=kernel_grad,
                                                logit_dtype=logit_dtype)
        return loss / jnp.maximum(count, 1), count

    (val, count), (gh, gk) = jax.value_and_grad(mean, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(kernel))
    return float(val), int(count), np.asarray(gh), np.asarray(gk)


@pytest.mark.parametrize("impl", ["scan", "fused"])
@pytest.mark.parametrize("case", ["pad_leg", "all_masked_chunk", "exact_chunks"])
def test_loss_and_grads_match_jax(impl, case):
    s = 48 if case == "exact_chunks" else 50
    hidden, kernel, labels = problem(3, s=s, masked_prefix=48 if case == "all_masked_chunk"
                                     else None)
    val, count, gh, gk = port(hidden, kernel, labels, impl)
    jval, jcount, jgh, jgk = jax_ref(hidden, kernel, labels, impl)
    assert count == jcount
    np.testing.assert_allclose(val, jval, rtol=1e-5)
    np.testing.assert_allclose(gh, jgh, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gk, jgk, atol=1e-5, rtol=1e-5)


def test_fused_without_kernel_grad():
    """kernel_grad=False: the hidden grad is unchanged and the kernel's
    cotangent is zeros (JAX returns zeros too)."""
    hidden, kernel, labels = problem(4)
    _, _, gh, gk = port(hidden, kernel, labels, "fused", kernel_grad=False)
    _, _, jgh, jgk = jax_ref(hidden, kernel, labels, "fused", kernel_grad=False)
    np.testing.assert_allclose(gh, jgh, atol=1e-5, rtol=1e-5)
    assert not gk.any() and not np.asarray(jgk).any()


def test_all_masked_batch_is_zero_and_finite():
    hidden, kernel, _ = problem(5)
    labels = np.full(hidden.shape[:2], -100, np.int32)
    for impl in ("scan", "fused"):
        hid = T(hidden).requires_grad_()
        loss, count = pce.chunked_cross_entropy(hid, T(kernel), T(labels), chunk_size=16,
                                                impl=impl)
        loss.backward()
        assert float(loss.detach()) == 0.0 and int(count) == 0 and not hid.grad.any()


def test_undifferentiated_fused_equals_scan():
    hidden, kernel, labels = problem(6)
    with torch.no_grad():
        a = pce.chunked_cross_entropy(T(hidden), T(kernel), T(labels), chunk_size=16, impl="scan")
        b = pce.chunked_cross_entropy(T(hidden), T(kernel), T(labels), chunk_size=16,
                                      impl="fused")
    np.testing.assert_allclose(float(a[0]), float(b[0]), rtol=1e-6)
    assert int(a[1]) == int(b[1])
    np.testing.assert_allclose(float(pce.cross_entropy_mean(T(hidden), T(kernel), T(labels), 16)),
                               float(jce.cross_entropy_mean(jnp.asarray(hidden),
                                                            jnp.asarray(kernel),
                                                            jnp.asarray(labels), 16)),
                               rtol=1e-5)


@pytest.mark.parametrize("impl", ["scan", "fused"])
def test_bf16_logit_rows_bounded_drift(impl):
    """bf16 logit rows (the CUDA default) track the fp32 path to bf16
    rounding scale: the JAX suite's bound, on the JAX suite's problem."""
    rng = np.random.RandomState(0)
    b, s, h, v = 2, 48, 64, 512
    hidden = rng.randn(b, s, h).astype(np.float32)
    kernel = (rng.randn(h, v) / np.sqrt(h)).astype(np.float32)
    labels = rng.randint(0, v, size=(b, s)).astype(np.int32)
    labels[:, :8] = -100
    l32, c32, g32, _ = port(hidden, kernel, labels, impl)
    l16, c16, g16, _ = port(hidden, kernel, labels, impl, logit_dtype=torch.bfloat16)
    assert abs(l16 - l32) < 2e-2 * max(1.0, l32)
    assert np.linalg.norm(g16 - g32) / np.linalg.norm(g32) < 5e-2
    assert c16 == c32
    # and the port's bf16 loss sits as close to JAX's bf16 loss as to fp32
    jl16 = jax_ref(hidden, kernel, labels, logit_dtype=jnp.bfloat16)[0]
    assert abs(l16 - jl16) < 2e-2 * max(1.0, l32)


def test_chunked_layout_matches_jax():
    hidden, _, labels = problem(7, s=37)
    hs, ls = pce._chunked(T(hidden), T(labels), 16)
    jhs, jls = jce._chunked(jnp.asarray(hidden), jnp.asarray(labels), 16)
    np.testing.assert_array_equal(hs.numpy(), np.asarray(jhs))
    np.testing.assert_array_equal(ls.numpy(), np.asarray(jls))

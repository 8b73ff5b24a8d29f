"""The port's ops against the JAX package's, on the same numpy inputs (fp32, CPU).

Kernel modules are compared through their plain versions, which the
wrappers run for CPU tensors; the JAX side runs its Pallas kernels in
interpret mode, as the JAX package's own tests do. Tolerance: 1e-5 abs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from livecc_tpu.ops import attention as jattn
from livecc_tpu.ops import norms as jnorms
from livecc_tpu.ops import rope as jrope
from livecc_tpu.ops.pallas.attention import flash_decode as jax_flash_decode
from livecc_tpu.ops.pallas.attention import flash_prefill as jax_flash_prefill
from livecc_tpu.ops.pallas.vit_attention import vit_group_attention as jax_vit_group_attention

from livecc_tpu_torch.ops import attention as pattn
from livecc_tpu_torch.ops import norms as pnorms
from livecc_tpu_torch.ops import rope as prope
from livecc_tpu_torch.ops.flash_attention import flash_decode, flash_prefill
from livecc_tpu_torch.ops.vit_attention import vit_group_attention
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5


def randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


T = torch.from_numpy


def test_norms():
    rng = np.random.RandomState(0)
    x, w, b = randn(rng, 3, 5, 64), randn(rng, 64), randn(rng, 64)
    close(pnorms.rms_norm(T(x), T(w), 1e-6), jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    close(pnorms.layer_norm(T(x), T(w), T(b), 1e-6),
          jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-6))


def test_vision_rope():
    rng = np.random.RandomState(1)
    grid = [(2, 4, 6)]
    cos, sin = prope.vision_rotary_cos_sin(grid, 80)
    jcos, jsin = jrope.vision_rotary_cos_sin(grid, 80)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    q, k = randn(rng, 48, 4, 80), randn(rng, 48, 4, 80)
    pq, pk = prope.apply_rotary_vision(T(q), T(k), T(cos), T(sin))
    jq, jk = jrope.apply_rotary_vision(jnp.asarray(q), jnp.asarray(k), jnp.asarray(cos), jnp.asarray(sin))
    close(pq, jq)
    close(pk, jk)


def test_mrope():
    rng = np.random.RandomState(2)
    pos = rng.randint(0, 3000, size=(3, 2, 7)).astype(np.int32)
    cos, sin = prope.mrope_cos_sin(T(pos), 16, 1e6, (2, 3, 3))
    jcos, jsin = jrope.mrope_cos_sin(jnp.asarray(pos), 16, 1e6, (2, 3, 3))
    close(cos, jcos)
    close(sin, jsin)
    q, k = randn(rng, 2, 7, 4, 16), randn(rng, 2, 7, 2, 16)
    pq, pk = prope.apply_mrope(T(q), T(k), cos, sin)
    jq, jk = jrope.apply_mrope(jnp.asarray(q), jnp.asarray(k), jcos, jsin)
    close(pq, jq)
    close(pk, jk)


def test_masks():
    np.testing.assert_array_equal(pattn.causal_mask(5, 9).numpy(), np.asarray(jattn.causal_mask(5, 9)))
    np.testing.assert_array_equal(pattn.kv_cache_mask(4, 12, 3).numpy(),
                                  np.asarray(jattn.kv_cache_mask(4, 12, 3)))
    off = np.asarray([0, 5], np.int32)
    np.testing.assert_array_equal(pattn.kv_cache_mask(4, 12, T(off)).numpy(),
                                  np.asarray(jattn.kv_cache_mask(4, 12, jnp.asarray(off))))
    seg = np.asarray([0, 0, 1, 1, 1, 2], np.int32)
    np.testing.assert_array_equal(pattn.segment_mask(T(seg)).numpy(),
                                  np.asarray(jattn.segment_mask(jnp.asarray(seg))))


@pytest.mark.parametrize("masked", [False, True])
def test_mha_and_bhsd(masked):
    rng = np.random.RandomState(3)
    q, k, v = randn(rng, 2, 6, 4, 16), randn(rng, 2, 9, 2, 16), randn(rng, 2, 9, 2, 16)
    mask = None
    if masked:
        mask = rng.rand(2, 1, 6, 9) > 0.4
        mask[0, 0, 2] = False                      # a fully masked row
    pm = None if mask is None else T(mask)
    jm = None if mask is None else jnp.asarray(mask)
    close(pattn.mha(T(q), T(k), T(v), pm), jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm))
    qt, kt, vt = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    close(pattn.mha_bhsd(T(qt), T(kt), T(vt), pm),
          jattn.mha_bhsd(jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt), jm))


@pytest.mark.parametrize("layered", [False, True])
def test_flash_prefill_plain_matches_pallas(layered):
    """B = 2 with per-row offsets, G = 2, kv_limit below the cache end, and
    Sq = 50 not a multiple of the JAX block (bq = 32)."""
    rng = np.random.RandomState(4)
    L, b, hq, hk, d, smax, sq = 3, 2, 4, 2, 64, 256, 50
    q = randn(rng, b, hq, sq, d)
    k5, v5 = randn(rng, L, b, hk, smax, d), randn(rng, L, b, hk, smax, d)
    off = np.asarray([100, 7], np.int32)
    limit = np.asarray([140, 7 + 33], np.int32)            # below offset + sq: padded rows
    if layered:
        kp, vp, kj, vj, li = T(k5), T(v5), jnp.asarray(k5), jnp.asarray(v5), 2
        out = flash_prefill(T(q), kp, vp, T(off), T(limit), layer_index=li)
        ref = jax_flash_prefill(jnp.asarray(q), kj, vj, jnp.asarray(off), jnp.asarray(limit),
                                jnp.int32(li), bq=32, bk=64, interpret=True)
    else:
        out = flash_prefill(T(q), T(k5[1]), T(v5[1]), T(off), T(limit))
        ref = jax_flash_prefill(jnp.asarray(q), jnp.asarray(k5[1]), jnp.asarray(v5[1]),
                                jnp.asarray(off), jnp.asarray(limit), bq=32, bk=64, interpret=True)
    assert out.shape == (b, hq, sq, d)
    close(out, ref)


def test_flash_prefill_row_without_keys_is_zero():
    rng = np.random.RandomState(5)
    q, k, v = randn(rng, 2, 2, 8, 16), randn(rng, 2, 1, 64, 16), randn(rng, 2, 1, 64, 16)
    off, limit = np.asarray([0, 4], np.int32), np.asarray([0, 10], np.int32)
    out = flash_prefill(T(q), T(k), T(v), T(off), T(limit))
    ref = jax_flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(off),
                            jnp.asarray(limit), bq=8, bk=32, interpret=True)
    assert torch.count_nonzero(out[0]) == 0
    close(out, ref)


@pytest.mark.parametrize("layered", [False, True])
def test_flash_decode_plain_matches_pallas(layered):
    rng = np.random.RandomState(6)
    L, b, hq, hk, d, smax = 2, 3, 4, 2, 64, 512
    q = randn(rng, b, hq, 1, d)
    k5, v5 = randn(rng, L, b, hk, smax, d), randn(rng, L, b, hk, smax, d)
    limits = np.asarray([1, 200, 512], np.int32)
    if layered:
        out = flash_decode(T(q), T(k5), T(v5), T(limits), layer_index=1)
        ref = jax_flash_decode(jnp.asarray(q), jnp.asarray(k5), jnp.asarray(v5),
                               jnp.asarray(limits), jnp.int32(1), bk=128, interpret=True)
    else:
        out = flash_decode(T(q), T(k5[0]), T(v5[0]), T(limits))
        ref = jax_flash_decode(jnp.asarray(q), jnp.asarray(k5[0]), jnp.asarray(v5[0]),
                               jnp.asarray(limits), bk=128, interpret=True)
    assert out.shape == (b, hq, 1, d)
    close(out, ref)


def test_vit_group_attention_plain_matches_pallas():
    rng = np.random.RandomState(7)
    q, k, v = (randn(rng, 2, 12, 2, 80) for _ in range(3))
    out = vit_group_attention(T(q), T(k), T(v))
    ref = jax_vit_group_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    assert out.shape == q.shape
    close(out, ref)


@pytest.mark.parametrize("op", ["prefill", "decode", "vit"])
def test_wrappers_raise_off_cpu_and_cuda(op):
    """Only CPU tensors take the plain version; a device with no kernel raises."""
    dev = torch.device("meta")
    q = torch.empty(1, 2, 1, 16, device=dev)
    k = torch.empty(1, 2, 8, 16, device=dev)
    with pytest.raises(RuntimeError, match="no kernel"):
        if op == "prefill":
            flash_prefill(q, k, k, 0, 1)
        elif op == "decode":
            flash_decode(q, k, k, 1)
        else:
            vit_group_attention(q, q, q)

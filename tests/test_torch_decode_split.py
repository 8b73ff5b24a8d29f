"""K2 / K2-int8's split-KV arithmetic on the CPU, against JAX ``flash_decode``.

The CUDA decode kernels split each row's keys into blocks of ``split``,
write each block's partial softmax state (m, l, acc) and merge the partials
in a second kernel. ``flash_decode_split_plain`` and
``flash_decode_merge_plain`` mirror the two kernels in PyTorch; here their
composition is held to the JAX Pallas kernel in interpret mode (``bk=128``,
as ``tests/test_torch_ops.py`` runs it) at limits on and around the split
boundaries, fp32 at 1e-5 and an int8 cache at the JAX package's own int8
kernel tolerance (atol 3e-5 / rtol 1e-4, ``tests/test_int8_kv.py``); bf16 by
``kernel_check.close``. ``kernel_check.close`` must pass the split plain
version and fail a dropped split (``kernel_check.drop_split``) at the shapes
the card is checked at.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from livecc_tpu.models.qwen2_vl.text import quantize_kv as jax_quantize_kv
from livecc_tpu.ops.pallas.attention import flash_decode as jax_flash_decode

from livecc_tpu_torch.models.qwen2_vl.text import quantize_kv
from livecc_tpu_torch.ops.flash_attention import (
    DECODE_MAX_GD, DECODE_SPLIT, by_subgroups, decode_subgroups, flash_decode,
    flash_decode_merge_plain, flash_decode_plain, flash_decode_split_plain)
from livecc_tpu_torch.tools import kernel_check
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.from_numpy
SPLIT, SMAX, D = 64, 256, 32
# per-row limits mixed in one batch: on and around a split boundary, none, all
LIMITS = [SPLIT + 1, 0, SMAX, 1, SPLIT, SPLIT - 1]
INT8_TOL = dict(atol=3e-5, rtol=1e-4)


def split_merge(q, k, v, limit, split, k_scale=None, v_scale=None):
    m, l, acc = flash_decode_split_plain(q, k, v, limit, split, k_scale, v_scale)
    return flash_decode_merge_plain(m, l, acc, q.dtype)


def cache(rng, shape, kind):
    """(JAX arrays, torch tensors) of K or V: (codes, lane-major scales) for
    int8 (the JAX quantizer, so both see the same cache), else (x, None)."""
    x = rng.randn(*shape).astype(np.float32)
    if kind != "int8":
        return (jnp.asarray(x), None), (T(x), None)
    codes, scale = jax_quantize_kv(jnp.asarray(x))
    scale = jnp.swapaxes(scale, -1, -2)
    return (codes, scale), (T(np.array(codes)), T(np.array(scale, np.float32)).bfloat16())


@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("hq,hk", [(7, 1), (4, 2)])           # G = 7 (the 7B's) and G = 2
@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_split_merge_matches_jax(kind, hq, hk, layered):
    rng = np.random.RandomState(hq + 10 * layered + (kind == "int8"))
    b = len(LIMITS)
    shape = (2, b, hk, SMAX, D) if layered else (b, hk, SMAX, D)
    (kj, ksj), (kp, ksp) = cache(rng, shape, kind)
    (vj, vsj), (vp, vsp) = cache(rng, shape, kind)
    q = rng.randn(b, hq, 1, D).astype(np.float32)
    lim = np.asarray(LIMITS, np.int32)
    li = 1 if layered else None
    ref = jax_flash_decode(jnp.asarray(q), kj, vj, jnp.asarray(lim),
                           None if li is None else jnp.int32(li), k_scale=ksj, v_scale=vsj,
                           bk=128, interpret=True)
    if layered:
        kp, vp = kp[li], vp[li]
        ksp, vsp = (None, None) if ksp is None else (ksp[li], vsp[li])
    out = split_merge(T(q), kp, vp, T(lim), SPLIT, ksp, vsp)
    tol = INT8_TOL if kind == "int8" else dict(atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)
    assert not out[LIMITS.index(0)].any()
    # the partials: splits past a row's limit are empty, the others hold l >= 1
    m, l, acc = flash_decode_split_plain(T(q), kp, vp, T(lim), SPLIT, ksp, vsp)
    nonempty = (torch.arange(SMAX // SPLIT) * SPLIT)[None, :] < T(lim)[:, None]
    assert bool((l >= 1)[nonempty[:, None].expand_as(l)].all())
    empty = ~nonempty[:, None].expand_as(l)
    assert bool((l[empty] == 0).all()) and bool(torch.isneginf(m[empty]).all())
    assert not acc[empty].any()


@pytest.mark.parametrize("hq,hk", [(7, 1), (4, 2)])
def test_split_merge_bf16_within_the_limit(hq, hk):
    """bf16 inputs: the split kernel rounds exp(s - m_split) to bf16, the plain
    version and JAX exp(s - m) with another m; both differences stay within
    ``kernel_check.close``'s bf16 limit."""
    rng = np.random.RandomState(20 + hq)
    b = len(LIMITS)
    q, k, v = (rng.randn(*s).astype(np.float32) for s in
               ((b, hq, 1, D), (b, hk, SMAX, D), (b, hk, SMAX, D)))
    qb, kb, vb = (T(x).bfloat16() for x in (q, k, v))
    lim = np.asarray(LIMITS, np.int32)
    out = split_merge(qb, kb, vb, T(lim), SPLIT)
    assert out.dtype == torch.bfloat16
    ref = jax_flash_decode(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(lim),
                           bk=128, interpret=True)
    assert kernel_check.close(out, T(np.asarray(ref, np.float32)), torch.bfloat16) <= 1.0
    assert kernel_check.close(out, flash_decode_plain(qb, kb, vb, T(lim)), torch.bfloat16) <= 1.0


@pytest.mark.parametrize("split", [1, 16, 100, 512])            # 100: no multiple; 512 > Smax
def test_split_sizes_match_the_plain_version(split):
    rng = np.random.RandomState(30 + split)
    b, hq, hk = len(LIMITS), 4, 2
    q, k, v = (T(rng.randn(*s).astype(np.float32)) for s in
               ((b, hq, 1, D), (b, hk, SMAX, D), (b, hk, SMAX, D)))
    lim = torch.tensor(LIMITS, dtype=torch.int32)
    out = split_merge(q, k, v, lim, split)
    np.testing.assert_allclose(out.numpy(), flash_decode_plain(q, k, v, lim).numpy(),
                               atol=1e-5, rtol=0)
    # the CPU route of flash_decode is the plain version
    assert torch.equal(flash_decode(q, k, v, lim), flash_decode_plain(q, k, v, lim))


def test_merge_of_empty_splits_is_zero():
    rng = np.random.RandomState(40)
    q, k, v = (T(rng.randn(*s).astype(np.float32)) for s in
               ((3, 4, 1, 16), (3, 2, 128, 16), (3, 2, 128, 16)))
    m, l, acc = flash_decode_split_plain(q, k, v, torch.tensor([0, 0, 0], dtype=torch.int32), 32)
    assert bool(torch.isneginf(m).all()) and not l.any()
    out = flash_decode_merge_plain(m, l, acc, torch.float32)
    assert out.shape == (3, 4, 1, 16) and not torch.isnan(out).any() and not out.any()
    out = split_merge(q, k, v, torch.tensor([0, 40, 0], dtype=torch.int32), 32)
    assert not torch.isnan(out).any() and not out[0].any() and not out[2].any() and out[1].all()


def test_close_and_drop_split_edges():
    ref = torch.tensor([[[[0.0, 0.0]]], [[[1.0, -2.0]]]])
    assert kernel_check.close(ref.clone(), ref, torch.float32) == 0.0      # zero rows: no NaN
    assert kernel_check.close(ref + 1e-3, ref, torch.float32) > 1.0
    with pytest.raises(AssertionError):
        kernel_check.close(ref * float("nan"), ref, torch.float32)
    q, k = torch.zeros(1, 2, 1, 16), torch.zeros(1, 1, 128, 16)
    with pytest.raises(ValueError):                         # the longest row has one split
        kernel_check.drop_split(q, k, k, 64, 64)


@pytest.mark.parametrize("name,group", [
    # the one-launch ring kernel: bf16 (bulk copies), int8 (cp.async of 8 bytes), fp32
    ("void livecc::(anonymous namespace)::decode_ring_kernel<__nv_bfloat16, false, 0>"
     "(livecc::(anonymous namespace)::DecodeParams)", "K2 flash_decode"),
    ("void livecc::(anonymous namespace)::decode_ring_kernel<__nv_bfloat16, true, 8>"
     "(livecc::(anonymous namespace)::DecodeParams)", "K2-int8 flash_decode_int8"),
    ("void livecc::(anonymous namespace)::decode_ring_kernel<float, false, 16>(...)",
     "K2 flash_decode"),
    # the split and merge kernels of older checkouts
    ("void livecc::(anonymous namespace)::decode_split_kernel<__nv_bfloat16, false, 16>"
     "(livecc::(anonymous namespace)::DecodeParams)", "K2 flash_decode"),
    ("void livecc::(anonymous namespace)::decode_merge_kernel<float, true>"
     "(livecc::(anonymous namespace)::DecodeParams)", "K2-int8 flash_decode_int8"),
    ("void livecc::(anonymous namespace)::decode_split_kernel<float, true, 8>(...)",
     "K2-int8 flash_decode_int8"),
    # K1-int8: the tensor-core kernel (bf16), the FMA kernel's fp32 instance
    # and its bf16 one of older checkouts
    ("void livecc::(anonymous namespace)::quant_mma_attention_kernel<128>"
     "(livecc::QuantMmaParams)", "K1-int8 flash_prefill_int8"),
    ("void livecc::(anonymous namespace)::tile_attention_kernel<float, true, true>(...)",
     "K1-int8 flash_prefill_int8"),
    ("void livecc::(anonymous namespace)::tile_attention_kernel<__nv_bfloat16, true, true>(...)",
     "K1-int8 flash_prefill_int8"),
    # the tensor-core K1 (and its split merge) and K3 (bf16: wgmma, and the
    # mma.sync kernel of older checkouts), and the FMA kernel's fp32 instances
    ("void livecc::(anonymous namespace)::wgmma_attention_kernel<128, false, true>"
     "(livecc::WgMaps, livecc::WgAttnParams)", "K1 flash_prefill"),
    ("void livecc::(anonymous namespace)::prefill_merge_kernel<128>(livecc::WgAttnParams)",
     "K1 flash_prefill"),
    ("void livecc::(anonymous namespace)::wgmma_attention_kernel<80, true, false>"
     "(livecc::WgMaps, livecc::WgAttnParams)", "K3 vit_group_attention"),
    ("void livecc::(anonymous namespace)::wgmma_attention_kernel<80, false, false>"
     "(livecc::WgMaps, livecc::WgAttnParams)", "K3 vit_group_attention"),
    ("void livecc::(anonymous namespace)::mma_attention_kernel<true, 128>(livecc::MmaParams)",
     "K1 flash_prefill"),
    ("void livecc::(anonymous namespace)::mma_attention_kernel<false, 80>(livecc::MmaParams)",
     "K3 vit_group_attention"),
    ("void livecc::(anonymous namespace)::tile_attention_kernel<float, false, false>(...)",
     "K3 vit_group_attention"),
    ("void livecc::(anonymous namespace)::tile_attention_kernel<float, true, false>(...)",
     "K1 flash_prefill"),
    # K4: the tensor-core kernels (bf16: the wgmma forward and backward, the
    # mma.sync forward and backward of older checkouts) and the FMA ones
    # (fp32; templated on the dtype in older checkouts)
    ("void livecc::(anonymous namespace)::train_fwd_wgmma_kernel<128, true>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, livecc::TrainAttnParams)",
     "K4 train_attention_fwd"),
    ("void livecc::(anonymous namespace)::train_fwd_mma_kernel<128>(livecc::TrainAttnParams)",
     "K4 train_attention_fwd"),
    ("void livecc::(anonymous namespace)::train_dkv_wgmma_kernel<128, true>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, livecc::TrainAttnParams)",
     "K4 train_attention_bwd"),
    ("void livecc::(anonymous namespace)::train_dq_wgmma_kernel<64, false>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, livecc::TrainAttnParams)",
     "K4 train_attention_bwd"),
    ("void livecc::(anonymous namespace)::train_dkv_mma_kernel<128>(livecc::TrainAttnParams)",
     "K4 train_attention_bwd"),
    ("void livecc::(anonymous namespace)::train_dq_mma_kernel<128>(livecc::TrainAttnParams)",
     "K4 train_attention_bwd"),
    ("void livecc::(anonymous namespace)::train_fwd_kernel(livecc::TrainAttnParams)",
     "K4 train_attention_fwd"),
    ("void livecc::(anonymous namespace)::train_dq_kernel<float>(livecc::TrainAttnParams)",
     "K4 train_attention_bwd"),
    # the one-kernel decode of older checkouts, which the script can also profile
    ("void livecc::(anonymous namespace)::decode_kernel<__nv_bfloat16, false>"
     "(livecc::(anonymous namespace)::DecodeParams)", "K2 flash_decode"),
    ("void livecc::(anonymous namespace)::decode_kernel<float, true>(...)",
     "K2-int8 flash_decode_int8"),
])
def test_profile_groups_the_decode_kernels(name, group):
    from livecc_tpu_torch.tools.profile_stream import _group

    assert _group(name) == group


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_check_fails_a_dropped_split_at_the_card_shapes(kind):
    """The card's timed decode shape (D = 128, G = 7, the pool's limits over
    a cache of 8192; one KV head here): the split plain version passes
    ``close`` against the plain version in the same dtype, a dropped split
    fails it at least 2x over."""
    gen = torch.Generator().manual_seed(50)
    b, hq, hk, d, smax = 8, 7, 1, 128, 8192
    lim = torch.tensor([1, 777, 8192, 4000, 1, 777, 8192, 2500], dtype=torch.int32)
    q = torch.randn((b, hq, 1, d), generator=gen).bfloat16()
    kv = [torch.randn((b, hk, smax, d), generator=gen).bfloat16() for _ in range(2)]
    scales = [None, None]
    if kind == "int8":
        (kv[0], scales[0]), (kv[1], scales[1]) = (quantize_kv(x) for x in kv)
        scales = [s.transpose(-1, -2).contiguous() for s in scales]
    ref = flash_decode_plain(q, *kv, lim, *scales)
    out = split_merge(q, *kv, lim, DECODE_SPLIT, *scales)
    fault = kernel_check.drop_split(q, *kv, lim, DECODE_SPLIT, *scales)
    assert kernel_check.close(out, ref, torch.bfloat16) <= 1.0
    assert kernel_check.close(fault, ref, torch.bfloat16) >= 2.0


@pytest.mark.parametrize("g,d,groups", [
    (7, 128, [(0, 7)]), (16, 128, [(0, 16)]), (32, 128, [(0, 16), (16, 32)]),
    (20, 128, [(0, 16), (16, 20)]), (48, 96, [(0, 21), (21, 42), (42, 48)]),
    (300, 8, [(0, 256), (256, 300)]),
])
def test_decode_subgroups(g, d, groups):
    """A group wider than one decode block (G·D > 2048) splits into runs of
    at most 2048 // D heads."""
    assert decode_subgroups(g, d) == groups


@pytest.mark.parametrize("b,hq,hk,d,limits", [
    (1, 32, 1, 128, [3000]), (2, 40, 2, 128, [700, 65]), (2, 48, 1, 96, [1, 4096]),
])
def test_by_subgroups_is_one_pass(b, hq, hk, d, limits):
    """The sub-group route (contiguous q per sub-group, output written back
    into place) gives what one pass over all heads gives: here with the
    plain version as each sub-group's attention."""
    gen = torch.Generator().manual_seed(hq + d)
    q = torch.randn((b, 1, hq, d), generator=gen).transpose(1, 2)
    k, v = (torch.randn((b, hk, 4096, d), generator=gen) for _ in range(2))
    lim = torch.tensor(limits, dtype=torch.int32)
    seen = []

    def attend(qs):
        assert qs.is_contiguous() and qs.shape[1] % hk == 0
        seen.append(qs.shape[1] // hk)
        return flash_decode_plain(qs, k, v, lim)

    out = by_subgroups(q, hk, decode_subgroups(hq // hk, d), attend)
    assert seen == [hi - lo for lo, hi in decode_subgroups(hq // hk, d)]
    np.testing.assert_allclose(out.numpy(), flash_decode_plain(q, k, v, lim).numpy(),
                               atol=1e-6, rtol=0)


def test_decode_split_is_the_kernels_constant():
    """The wrapper sizes the workspace for ``DECODE_SPLIT`` keys per split,
    the header's ``kDecSplit`` (whose C entry points refuse any other)."""
    import livecc_tpu_torch

    header = Path(livecc_tpu_torch.__file__).parent / "csrc" / "decode_attention.cuh"
    found = re.findall(r"constexpr int kDecSplit = (\d+);", header.read_text())
    assert found == [str(DECODE_SPLIT)]
    found = re.findall(r"constexpr int kDecMaxOut = (\d+);", header.read_text())
    assert found == [str(DECODE_MAX_GD)]

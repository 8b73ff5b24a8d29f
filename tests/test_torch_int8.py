"""The port's int8 KV cache against the JAX package's, piece by piece.

``quantize_kv``, the int8 branches of K1/K2 (the port's plain versions here,
on CPU tensors, against the JAX Pallas kernels in interpret mode), the cached
text tower on an int8 cache, compaction of a quantized row and the
single-stream engine on an int8 cache. Inputs are numpy arrays from a seed;
fp32 unless a test says otherwise. Kernel tolerance atol 3e-5 / rtol 1e-4,
as the JAX package's own int8 kernel tests (``tests/test_int8_kv.py``).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.data.tokenizer import ByteTokenizer
from livecc_tpu.engine import GenerationParams as JaxGenerationParams
from livecc_tpu.engine import LiveCCEngine as JaxEngine
from livecc_tpu.engine.compact import compact_cache_row as jax_compact_cache_row
from livecc_tpu.models import qwen2_vl as jm
from livecc_tpu.models.qwen2_vl.text import quantize_kv as jax_quantize_kv
from livecc_tpu.ops.pallas.attention import flash_decode as jax_flash_decode
from livecc_tpu.ops.pallas.attention import flash_prefill as jax_flash_prefill

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer as PortByteTokenizer
from livecc_tpu_torch.engine import GenerationParams, LiveCCEngine
from livecc_tpu_torch.engine.compact import compact_cache_row
from livecc_tpu_torch.models import qwen2_vl as pm
from livecc_tpu_torch.models.qwen2_vl.text import quantize_kv
from livecc_tpu_torch.ops.flash_attention import flash_decode, flash_prefill
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "hf_tiny.npz")
T = torch.from_numpy
KERNEL_TOL = dict(atol=3e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    state = {k[len("state::"):]: g[k] for k in g.files if k.startswith("state::")}
    params = jm.convert_state_dict(state, jax_tiny_config())
    return params, pm.params_from_jax(jax.tree_util.tree_map(np.asarray, params), tiny_config())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax(dtype):
    """Codes and scales identical to JAX's (jitted, as the text tower runs
    it), in fp32 and in bf16, where amax, the scale and ``x / scale`` are
    bf16 arithmetic in both."""
    x = np.random.RandomState(0).randn(3, 4, 200, 64).astype(np.float32) * 2.5
    x[0, 0, 0] = 0.0                                   # an all-zero row: scale 1e-8 / 127
    codes_j, scale_j = jax.jit(jax_quantize_kv)(jnp.asarray(x, getattr(jnp, dtype)))
    codes, scale = quantize_kv(T(x).to(getattr(torch, dtype)))
    assert codes.dtype == torch.int8 and scale.dtype == torch.bfloat16
    assert codes.shape == x.shape and scale.shape == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(scale.float().numpy(), np.asarray(scale_j, np.float32))
    assert np.abs(codes.numpy()).max() == 127


def _int8_cache(rng, shape):
    """int8 codes [..., Smax, D] and lane-major scales [..., 1, Smax], both
    frameworks' (the JAX quantizer, so the kernels see the same cache)."""
    codes, scale = jax_quantize_kv(jnp.asarray(rng.randn(*shape).astype(np.float32)))
    scale = jnp.swapaxes(scale, -1, -2)
    return (codes, scale), (T(np.array(codes)), T(np.array(scale, np.float32)).bfloat16())


@pytest.mark.parametrize("layered", [False, True])
def test_int8_flash_prefill_matches_jax_kernel(layered):
    rng = np.random.RandomState(1)
    L, b, hq, hk, d, smax, sq = 3, 2, 4, 2, 64, 256, 32
    shape = (L, b, hk, smax, d) if layered else (b, hk, smax, d)
    (kj, ksj), (kp, ksp) = _int8_cache(rng, shape)
    (vj, vsj), (vp, vsp) = _int8_cache(rng, shape)
    q = rng.randn(b, hq, sq, d).astype(np.float32)
    off = np.asarray([64, 130], np.int32)
    lim = np.asarray([96, 150], np.int32)                # row 1 stops mid-chunk
    li = 1 if layered else None
    ref = jax_flash_prefill(jnp.asarray(q), kj, vj, jnp.asarray(off), jnp.asarray(lim),
                            None if li is None else jnp.int32(li), k_scale=ksj, v_scale=vsj,
                            bq=32, bk=64, interpret=True)
    out = flash_prefill(T(q), kp, vp, T(off), T(lim), layer_index=li, k_scale=ksp, v_scale=vsp)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)


@pytest.mark.parametrize("layered", [False, True])
def test_int8_flash_decode_matches_jax_kernel(layered):
    rng = np.random.RandomState(2)
    L, b, hq, hk, d, smax = 2, 3, 4, 2, 64, 256
    shape = (L, b, hk, smax, d) if layered else (b, hk, smax, d)
    (kj, ksj), (kp, ksp) = _int8_cache(rng, shape)
    (vj, vsj), (vp, vsp) = _int8_cache(rng, shape)
    q = rng.randn(b, hq, 1, d).astype(np.float32)
    lim = np.asarray([200, 9, 0], np.int32)              # a row with no valid key -> 0
    li = 1 if layered else None
    ref = jax_flash_decode(jnp.asarray(q), kj, vj, jnp.asarray(lim),
                           None if li is None else jnp.int32(li), k_scale=ksj, v_scale=vsj,
                           bk=128, interpret=True)
    out = flash_decode(T(q), kp, vp, T(lim), layer_index=li, k_scale=ksp, v_scale=vsp)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)
    assert not out[2].any()


def test_int8_kv_cache_layout():
    cfg = tiny_config().text
    cache = pm.KVCache.zeros(cfg, 3, 64, torch.int8)
    assert cache.quantized and cache.k.dtype == torch.int8
    assert cache.k_scale.shape == (cfg.num_hidden_layers, 3, cfg.num_key_value_heads, 1, 64)
    assert cache.k_scale.dtype == torch.bfloat16 and cache.max_len == 64
    assert not pm.KVCache.zeros(cfg, 1, 64).quantized


def test_int8_cached_text_forward_matches_jax(golden):
    """A padded B = 2 prefill at per-row offsets, then decode steps, on an
    int8 cache: hidden states, and the whole cache (codes, scales at their
    per-row depths, offsets), against JAX ``text_forward`` with its Pallas
    kernels in interpret mode."""
    params, model = golden
    jcfg, cfg = jax_tiny_config().text, tiny_config().text
    rng = np.random.RandomState(3)
    b, s, smax = 2, 24, 128
    emb = rng.randn(b, s, cfg.hidden_size).astype(np.float32)
    start = np.asarray([5, 40], np.int32)
    valid = np.asarray([24, 11], np.int32)
    jcache = jm.KVCache.zeros(jcfg, b, smax, jnp.int8)
    jcache = jm.KVCache(jcache.k, jcache.v, jnp.asarray(start), jcache.k_scale, jcache.v_scale)
    pcache = pm.KVCache.zeros(cfg, b, smax, torch.int8)
    pcache.offset = T(start.copy())
    steps = [(emb, start + valid)]
    for _ in range(3):
        steps.append((rng.randn(b, 1, cfg.hidden_size).astype(np.float32), None))
    for e, lim in steps:
        sl = e.shape[1]
        pos = np.broadcast_to((np.asarray(pcache.offset)[:, None] + np.arange(sl))[None],
                              (3, b, sl)).astype(np.int32)
        with pltpu.force_tpu_interpret_mode():
            jh, jcache = jm.text_forward(params["text"], jcfg, jnp.asarray(e), jnp.asarray(pos),
                                         cache=jcache, use_flash=True,
                                         kv_limit=None if lim is None else jnp.asarray(lim))
        ph, pcache = pm.text_forward(model.text, cfg, T(e), T(pos), pcache,
                                     kv_limit=None if lim is None else T(lim))
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=1e-5, rtol=0)
        if lim is not None:                      # the prefill's advance is valid_len
            jcache = jm.KVCache(jcache.k, jcache.v, jnp.asarray(lim), jcache.k_scale,
                                jcache.v_scale)
            pcache.offset = T(lim.copy())
    np.testing.assert_array_equal(pcache.offset.numpy(), np.asarray(jcache.offset))
    for port, ref in ((pcache.k, jcache.k), (pcache.v, jcache.v)):
        diff = np.abs(port.numpy().astype(np.int32) - np.asarray(ref, np.int32))
        # K/V go through rope and projections in two frameworks: a value on a
        # rounding boundary may land one code apart, never more
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    for port, ref in ((pcache.k_scale, jcache.k_scale), (pcache.v_scale, jcache.v_scale)):
        np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=1e-2, atol=0)
        assert (port.float().numpy() > 0).sum() == (np.asarray(ref, np.float32) > 0).sum()


def test_int8_compaction_gathers_scales_like_jax():
    cfg = tiny_config().text
    jcfg = jax_tiny_config().text
    rng = np.random.RandomState(4)
    c, smax = 3, 64
    jcache = jm.KVCache.zeros(jcfg, c, smax, jnp.int8)
    k = rng.randint(-127, 128, size=jcache.k.shape).astype(np.int8)
    v = rng.randint(-127, 128, size=jcache.k.shape).astype(np.int8)
    ks = rng.rand(*jcache.k_scale.shape).astype(np.float32)
    vs = rng.rand(*jcache.k_scale.shape).astype(np.float32)
    off = np.asarray([10, 48, 0], np.int32)
    jcache = jm.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(off),
                        jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16))
    pcache = pm.KVCache(T(k.copy()), T(v.copy()), T(off.copy()), T(ks).bfloat16(),
                        T(vs).bfloat16())
    ref = jax_compact_cache_row(jcache, jnp.int32(1), jnp.int32(8), jnp.int32(16))
    out = compact_cache_row(pcache, 1, 8, 16)
    np.testing.assert_array_equal(out.offset.numpy(), np.asarray(ref.offset))
    np.testing.assert_array_equal(out.k.numpy(), np.asarray(ref.k))
    np.testing.assert_array_equal(out.v.numpy(), np.asarray(ref.v))
    np.testing.assert_array_equal(out.k_scale.float().numpy(), np.asarray(ref.k_scale, np.float32))
    np.testing.assert_array_equal(out.v_scale.float().numpy(), np.asarray(ref.v_scale, np.float32))


def frames(seed, n=2, h=28, w=28):
    return np.random.RandomState(seed).randint(0, 255, size=(n, h, w, 3), dtype=np.uint8)


def test_int8_engine_matches_jax_through_cache_growth(golden):
    """The single-stream engine on an int8 cache that starts at 64 positions
    and doubles (K/V and their scales) twice: the same text as JAX's int8
    engine, chunk for chunk."""
    params, model = golden
    kw = dict(max_new_tokens=4, eos_token_id=3, pad_token_id=0, repetition_penalty=1.05)
    jax_eng = JaxEngine(params, jax_tiny_config(), ByteTokenizer(), cache_len=256,
                        cache_dtype=jnp.int8, use_flash=False, quantize_weights=False)
    eng = LiveCCEngine(model, tiny_config(), PortByteTokenizer(), cache_len=256,
                       cache_dtype=torch.int8)
    js, ps = jax_eng.new_stream(cache_len=64), eng.new_stream(cache_len=64)
    assert ps.cache.quantized and ps.cache.max_len == 64
    out_j = [jax_eng.chunk_step(js, frames(0, 6), 0.0, 3.0, "q", JaxGenerationParams(**kw))]
    out_p = [eng.chunk_step(ps, frames(0, 6), 0.0, 3.0, "q", GenerationParams(**kw))]
    for i in range(3):
        out_j.append(jax_eng.chunk_step(js, frames(i + 1), 3.0 + i, 4.0 + i, None,
                                        JaxGenerationParams(**kw)))
        out_p.append(eng.chunk_step(ps, frames(i + 1), 3.0 + i, 4.0 + i, None,
                                    GenerationParams(**kw)))
    assert out_p == out_j
    assert ps.cache.max_len == js.cache.max_len > 64
    assert ps.cache.k_scale.shape[-1] == ps.cache.max_len
    assert eng.metrics.summary("chunk_step")["n"] == 4

"""The port's streaming engine against the JAX LiveCCEngine, token for token.

Both engines get the hf_tiny golden weights (JAX ``convert_state_dict``,
carried across by ``params_from_jax``), the same uint8 frames from a numpy
seed, fp32 on the CPU, greedy decoding with repetition penalty 1.05. The
port runs its kernels' plain versions here (CPU tensors).
"""

import os

import numpy as np
import pytest
import torch

import jax

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.data.tokenizer import ByteTokenizer
from livecc_tpu.engine import GenerationParams as JaxGenerationParams
from livecc_tpu.engine import LiveCCEngine as JaxEngine
from livecc_tpu.engine.generation import update_counts as jax_update_counts
from livecc_tpu.models import qwen2_vl as jm

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer as PortByteTokenizer
from livecc_tpu_torch.engine import GenerationParams, LiveCCEngine, update_counts
from livecc_tpu_torch.models.qwen2_vl import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "hf_tiny.npz")


@pytest.fixture(scope="module")
def weights():
    g = np.load(GOLDEN)
    cfg = jax_tiny_config()
    state = {k[len("state::"):]: g[k] for k in g.files if k.startswith("state::")}
    params = jm.convert_state_dict(state, cfg)
    return params, jax.tree_util.tree_map(np.asarray, params)


def synth_frames(n, h=28, w=28, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 255, size=(n, h, w, 3), dtype=np.uint8)


def _engines(weights, **kw):
    params, tree = weights
    cfg = tiny_config()
    jax_eng = JaxEngine(params, jax_tiny_config(), ByteTokenizer(), use_flash=False,
                        quantize_weights=False, **kw)
    port_eng = LiveCCEngine(params_from_jax(tree, cfg), cfg, PortByteTokenizer(), **kw)
    return jax_eng, port_eng


def test_live_cc_once_for_evaluation_matches_jax(weights):
    jax_eng, port_eng = _engines(weights, cache_len=512)
    frames = synth_frames(12)             # 6-frame first chunk + 3 two-frame chunks
    ref = jax_eng.live_cc_once_for_evaluation("describe", frames, max_new_tokens=16)
    out = port_eng.live_cc_once_for_evaluation("describe", frames, max_new_tokens=16)
    assert len(out) == 4
    assert out == ref
    assert len(port_eng.chunk_log) == 4
    assert all(0 < r.generated_tokens <= 16 for r in port_eng.chunk_log)


def test_session_across_compaction_matches_jax(weights):
    kw = dict(cache_len=256, compact_keep=96, compact_sink_cap=64)
    jax_eng, port_eng = _engines(weights, **kw)
    jgen = JaxGenerationParams(max_new_tokens=4, eos_token_id=3, pad_token_id=0,
                               repetition_penalty=1.05)
    gen = GenerationParams(max_new_tokens=4, eos_token_id=3, pad_token_id=0,
                           repetition_penalty=1.05)
    js, ps = jax_eng.new_stream(), port_eng.new_stream()
    texts_j = [jax_eng.chunk_step(js, synth_frames(6), 0.0, 3.0, "q", jgen)]
    texts_p = [port_eng.chunk_step(ps, synth_frames(6), 0.0, 3.0, "q", gen)]
    t = 3.0
    for i in range(12):
        texts_j.append(jax_eng.chunk_step(js, synth_frames(2, seed=i + 1), t, t + 1.0, None, jgen))
        texts_p.append(port_eng.chunk_step(ps, synth_frames(2, seed=i + 1), t, t + 1.0, None, gen))
        t += 1.0
        assert ps.past_ids == js.past_ids
        assert (ps.length, ps.rope_delta) == (js.length, js.rope_delta)
        assert ps.length == int(ps.cache.offset[0])
    assert texts_p == texts_j
    assert sum(r.dropped_tokens for r in port_eng.chunk_log) >= 1    # crossed a compaction
    assert ps.cache.max_len == 256


def test_update_counts_accumulates_repeated_ids():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 6, size=(2, 16)).astype(np.int32)     # many repeats
    counts = rng.randint(0, 3, size=(2, 8)).astype(np.int32)
    valid_len = np.asarray([16, 9], np.int32)
    remove = np.asarray([2, -1], np.int32)
    ref = np.asarray(jax_update_counts(jax.numpy.asarray(counts), jax.numpy.asarray(ids),
                                       jax.numpy.asarray(valid_len), jax.numpy.asarray(remove)))
    out = update_counts(torch.from_numpy(counts.copy()), torch.from_numpy(ids),
                        torch.from_numpy(valid_len), torch.from_numpy(remove))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert ref.sum() > counts.sum() + 16    # repeats really accumulated


def test_qa_turn_matches_jax(weights):
    """A QA turn over the shared cache, after a commentary chunk."""
    jax_eng, port_eng = _engines(weights, cache_len=512)
    kw = dict(max_new_tokens=8, eos_token_id=3, pad_token_id=0, repetition_penalty=1.05)
    jgen, gen = JaxGenerationParams(**kw), GenerationParams(**kw)
    js, ps = jax_eng.new_stream(), port_eng.new_stream()
    out_j = [jax_eng.chunk_step(js, synth_frames(6), 0.0, 3.0, None, jgen),
             jax_eng.qa_turn(js, None, "what is it?", jgen),
             jax_eng.qa_turn(js, synth_frames(2, seed=5), "and now?", jgen)]
    out_p = [port_eng.chunk_step(ps, synth_frames(6), 0.0, 3.0, None, gen),
             port_eng.qa_turn(ps, None, "what is it?", gen),
             port_eng.qa_turn(ps, synth_frames(2, seed=5), "and now?", gen)]
    assert out_p == out_j
    assert ps.past_ids == js.past_ids


def test_decode_chunk_rows_stop_apart_like_jax():
    """B = 3: one row runs to max_new_tokens, one emits eos at once, one is
    steered by a ramping streaming threshold; tokens, counts and per-row
    offsets match the JAX decode loop (early exit, final token not
    forwarded)."""
    from livecc_tpu.engine.generation import decode_chunk as jax_decode_chunk

    from livecc_tpu_torch.engine.generation import decode_chunk
    from livecc_tpu_torch.models.qwen2_vl import KVCache as PortKVCache

    jcfg, cfg = jax_tiny_config(), tiny_config()
    params = jm.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg)
    rng = np.random.RandomState(0)
    b, v = 3, cfg.text.vocab_size
    logits0 = rng.randn(b, v).astype(np.float32)
    logits0[0, 42] = 10.0
    logits0[1, cfg.eos_token_id] = 10.0
    counts = rng.randint(0, 2, size=(b, v)).astype(np.int32)
    kw = dict(max_new_tokens=6, eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
              repetition_penalty=1.05, streaming_eos_token_id=42,
              streaming_threshold_base=0.2, streaming_threshold_step=0.1)
    offsets = np.asarray([8, 3, 11], np.int32)
    delta = np.asarray([[0], [2], [-1]], np.int32)

    jcache = jm.KVCache.zeros(jcfg.text, b, 64)
    jcache = jm.KVCache(jcache.k, jcache.v, jax.numpy.asarray(offsets))
    jt, jn, jcache, jc = jax_decode_chunk(
        params, jcfg, JaxGenerationParams(**kw), jax.numpy.asarray(logits0), jcache,
        jax.numpy.asarray(counts), jax.numpy.asarray(delta), jax.random.PRNGKey(0))
    pcache = PortKVCache.zeros(cfg.text, b, 64)
    pcache.offset = torch.from_numpy(offsets.copy())
    pt, pn, pcache, pc = decode_chunk(
        model, cfg, GenerationParams(**kw), torch.from_numpy(logits0), pcache,
        torch.from_numpy(counts.copy()), torch.from_numpy(delta))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pcache.offset.numpy(), np.asarray(jcache.offset))
    assert int(pn[1]) == 1 and int(pn[0]) == 6


def test_adjust_logits_matches_jax():
    from livecc_tpu.engine.generation import adjust_logits as jax_adjust_logits

    from livecc_tpu_torch.engine.generation import adjust_logits

    rng = np.random.RandomState(1)
    logits = (rng.randn(2, 32) * 3).astype(np.float32)
    counts = rng.randint(0, 2, size=(2, 32)).astype(np.int32)
    kw = dict(repetition_penalty=1.3, streaming_eos_token_id=5,
              streaming_threshold_base=0.01, streaming_threshold_step=0.02)
    for step in (0, 3):
        ref = jax_adjust_logits(jax.numpy.asarray(logits), jax.numpy.asarray(counts),
                                JaxGenerationParams(**kw), step)
        out = adjust_logits(torch.from_numpy(logits), torch.from_numpy(counts),
                            GenerationParams(**kw), step)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("filt", [dict(top_k=1), dict(top_p=1e-6)])
def test_sampling_filters_reduce_to_greedy(filt):
    """top_k = 1 or a tiny top_p leaves one token: sampling equals argmax
    (the port's generator cannot reproduce JAX's random bits)."""
    from livecc_tpu_torch.engine.generation import select_token

    logits = torch.from_numpy(np.random.RandomState(2).randn(4, 50).astype(np.float32))
    greedy = select_token(logits, GenerationParams())
    gen = torch.Generator().manual_seed(0)
    sampled = select_token(logits, GenerationParams(do_sample=True, temperature=0.7, **filt), gen)
    assert torch.equal(sampled, greedy)

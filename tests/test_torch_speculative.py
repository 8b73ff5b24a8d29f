"""The port's speculative decoding against the JAX package's, on the CPU.

Tiny config, fp32, the JAX test suite's random weights (``init_params``,
PRNGKey 7) carried across by ``params_from_jax``; uint8 frames and other
inputs from numpy seeds; greedy decoding with repetition penalty 1.05. The
JAX engine runs its XLA reference path on the CPU, the port its kernels'
plain versions and its eager lookahead loop (``decode_chunk_lookahead_plain``;
the card replays the same ``lookahead_step`` as a CUDA graph,
``engine/graphs.py``). Greedy speculative output must be token-identical
to JAX's and to the port's own plain ``decode_chunk``. Fused runs pin
``adaptive=False``, so every chunk runs lookahead and the two packages'
``hist`` shadows can be compared over the committed history.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from livecc_tpu.engine import GenerationParams as JaxGenerationParams
from livecc_tpu.engine import LiveCCEngine as JaxEngine
from livecc_tpu.engine import speculative as jspec
from livecc_tpu.engine.compact import compact_token_row as jax_compact_token_row
from livecc_tpu.models import qwen2_vl as jm
from livecc_tpu.serve.scheduler import StreamServer as JaxStreamServer

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.engine import GenerationParams, LiveCCEngine
from livecc_tpu_torch.engine.compact import compact_token_row
from livecc_tpu_torch.engine.graphs import graph_key, run_steps
from livecc_tpu_torch.engine.speculative import (
    LookaheadState, NGramDraftSource, SpecConfig, SpecController, accept_scan,
    decode_chunk_lookahead_plain, lookahead_epilogue, lookahead_prologue, lookahead_step,
    ngram_draft)
from livecc_tpu_torch.models.qwen2_vl import KVCache, params_from_jax
from livecc_tpu_torch.serve import StreamServer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GEN = dict(max_new_tokens=6, eos_token_id=3, pad_token_id=0, repetition_penalty=1.05)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_tiny_config(), tiny_config()
    params = jm.init_params(jcfg, jax.random.PRNGKey(7))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg)
    return dict(jcfg=jcfg, cfg=cfg, params=params, model=model)


def synth_frames(n, h=28, w=28, seed=0):
    return np.random.RandomState(seed).randint(0, 255, size=(n, h, w, 3), dtype=np.uint8)


def jax_engine(setup, spec=None, cache_dtype=jnp.float32, **kw):
    kw.setdefault("cache_len", 512)
    jspec_cfg = None if spec is None else jspec.SpecConfig(**dataclasses.asdict(spec))
    return JaxEngine(setup["params"], setup["jcfg"], JaxByteTokenizer(), use_flash=False,
                     quantize_weights=False, cache_dtype=cache_dtype, spec=jspec_cfg, **kw)


def port_engine(setup, spec=None, cache_dtype=torch.float32, **kw):
    kw.setdefault("cache_len", 512)
    return LiveCCEngine(setup["model"], setup["cfg"], ByteTokenizer(), cache_dtype=cache_dtype,
                        spec=spec, **kw)


def run_stream(engine, gen, n_chunks=3, seed=1, stream_cache_len=512):
    """The same chunk sequence through either package's engine: texts, state."""
    st = engine.new_stream(cache_len=stream_cache_len)
    texts, t = [], 0.0
    for i in range(n_chunks):
        t0, t1 = (0.0, 3.0) if i == 0 else (t, t + 1.0)
        texts.append(engine.chunk_step(st, synth_frames(6 if i == 0 else 2, seed=seed + i), t0,
                                       t1, "describe" if i == 0 else None, gen))
        t = t1
    return texts, st


def gens(**kw):
    """(JAX, port) GenerationParams with the same fields."""
    fields = {**GEN, **kw}
    return JaxGenerationParams(**fields), GenerationParams(**fields)


@pytest.fixture(scope="module")
def plain_runs(setup):
    """The port's plain decode_chunk engine: {(max_new_tokens, cache dtype): (texts, state)}."""
    out = {}
    for max_new, dtype in ((6, torch.float32), (5, torch.int8)):
        out[max_new, dtype] = run_stream(port_engine(setup, cache_dtype=dtype),
                                         gens(max_new_tokens=max_new)[1])
    return out


def assert_same_session(a, b, hist=False):
    (texts_a, st_a), (texts_b, st_b) = a, b
    assert texts_a == texts_b
    assert list(st_a.past_ids) == list(st_b.past_ids)
    assert (st_a.length, st_a.last_token, st_a.rope_delta) == (st_b.length, st_b.last_token,
                                                             st_b.rope_delta)
    if hist:      # the id-shadow over the committed history
        n = st_a.length
        np.testing.assert_array_equal(np.asarray(st_a.hist)[0, :n], np.asarray(st_b.hist)[0, :n])


# -- the verification core ----------------------------------------------------

B, V = 5, 40


def scan_inputs(k):
    """Seeded logits whose argmax chain each row follows, drafts that match
    it in row 0, miss at j = 1 in row 1, reach eos at j = 2 in row 2; row 3
    starts stopped, row 4 is two tokens from the cap; a streaming threshold
    ramps over the steps."""
    rng = np.random.RandomState(k)
    seq = rng.randint(8, V, size=(B, k + 1))
    if k >= 2:
        seq[2, 2] = 3                                       # eos
    seq[1, 0] = 5                                           # the streaming eos, masked by the ramp
    srcs = rng.randn(B, k + 1, V).astype(np.float32)
    srcs[np.arange(B)[:, None], np.arange(k + 1)[None, :], seq] += 8.0
    draft = seq.copy()
    if k >= 1:
        draft[1, 1] = (seq[1, 1] + 1) % V
    draft[:, k] = -1
    counts = rng.randint(0, 2, size=(B, V)).astype(np.int32)
    step_idx = np.asarray([0, 2, 1, 0, 4], np.int32)
    stopped = np.asarray([False, False, False, True, False])
    gen = dict(max_new_tokens=6, eos_token_id=3, pad_token_id=0, repetition_penalty=1.05,
               streaming_eos_token_id=5, streaming_threshold_base=0.0,
               streaming_threshold_step=0.5)
    return gen, srcs, draft.astype(np.int32), counts, step_idx, stopped


@pytest.mark.parametrize("k", [0, 4])
def test_accept_scan_matches_jax(k):
    """Exact tokens, emitted counts, presence counts and stop flags: full
    acceptance, a miss, eos, a row that starts stopped, the per-chunk cap,
    and the threshold at per-row step indices; k = 0 is the seed token."""
    gen, srcs, draft, counts, step_idx, stopped = scan_inputs(k)
    ref = jspec._accept_scan(JaxGenerationParams(**gen), k, jnp.asarray(srcs), jnp.asarray(draft),
                             jnp.asarray(counts), jnp.asarray(step_idx), jnp.asarray(stopped),
                             jax.random.PRNGKey(0))
    out = accept_scan(GenerationParams(**gen), k, torch.from_numpy(srcs), torch.from_numpy(draft),
                      torch.from_numpy(counts.copy()), torch.from_numpy(step_idx),
                      torch.from_numpy(stopped))
    for a, r in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    if k == 4:
        emitted = out[1].tolist()
        assert emitted[3] == 0 and emitted[4] == 2           # stopped row, the cap
        assert emitted[0] == 5 and emitted[2] == 3           # full acceptance, eos at j = 2
        assert bool(out[3][2])


# -- drafting -----------------------------------------------------------------

NGRAM_CASES = [
    ([1, 2, 3, 9, 9, 1, 2, 3], 3, 4),
    ([5, 6], 3, 4),
    ([1, 2, 7, 7, 1, 2, 8, 8, 1, 2], 3, 4),
    ([4, 4, 4, 4], 2, 3),
    ([1], 3, 2),
    ([], 3, 2),
    ([9, 1, 2, 3, 1, 2], 2, 5),
    ([7, 8, 7, 8, 7], 1, 6),
]


@pytest.mark.parametrize("ids,max_ngram,k", NGRAM_CASES)
def test_ngram_draft_source_matches_jax(ids, max_ngram, k):
    assert (NGramDraftSource(max_ngram, k).propose(ids, pad_token_id=0)
            == jspec.NGramDraftSource(max_ngram, k).propose(ids, pad_token_id=0))


def test_device_ngram_draft_matches_the_host_source():
    """The device lookup over ``hist[b, :off + 1]`` against
    ``NGramDraftSource.propose`` on the same ids: seeded histories of a small
    alphabet (many repeats) with -1 holes, every offset from 0 to the end."""
    rng = np.random.RandomState(3)
    hcap, k, pad = 40, 5, 0
    for max_ngram in (1, 2, 3):
        hist = rng.randint(1, 4, size=(6, hcap)).astype(np.int32)
        hist[rng.rand(6, hcap) < 0.1] = -1
        src = NGramDraftSource(max_ngram, k)
        for off in range(hcap):
            offs = np.full((6,), off, np.int32)
            out = ngram_draft(torch.from_numpy(hist), torch.from_numpy(offs), k, max_ngram, pad)
            for b in range(6):
                assert out[b].tolist() == src.propose(hist[b, :off + 1].tolist(), pad), (b, off)


# -- the engine ----------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("k_draft", [1, 3, 5])
def test_greedy_parity(setup, plain_runs, k_draft, fused):
    """Port spec == JAX spec == the port's plain decode over 3 chunks: texts,
    history, lengths, the id-shadow (fused) and the committed K cache."""
    spec = SpecConfig(k_draft=k_draft, fused=fused, adaptive=False)
    jgen, gen = gens()
    ref = run_stream(jax_engine(setup, spec), jgen)
    eng = port_engine(setup, spec)
    out = run_stream(eng, gen)
    assert_same_session(out, ref, hist=fused)
    assert_same_session(out, plain_runs[6, torch.float32])
    n = out[1].length
    np.testing.assert_allclose(out[1].cache.k[:, :, :, :n].numpy(),
                               np.asarray(ref[1].cache.k)[:, :, :, :n], rtol=1e-3, atol=1e-5)
    assert all(r.windows > 0 for r in eng.chunk_log)


class AdversarialDraft:
    """Always the same token (the tiny eos): worst-case acceptance."""

    def __init__(self, k, token=3):
        self.k, self.token = k, token

    def propose(self, ids, pad_token_id=0):
        return [self.token] * self.k


class OracleDraft:
    """The reference run's tokens: full acceptance."""

    def __init__(self, k):
        self.k, self.expected, self.base = k, [], 0

    def propose(self, ids, pad_token_id=0):
        done = len(ids) - self.base
        out = self.expected[done:done + self.k]
        return out + [pad_token_id] * (self.k - len(out))


def test_oracle_drafts_take_few_windows(setup, plain_runs):
    """Perfect drafts: the plain engine's output, each chunk in at most
    ceil(max_new / (k + 1)) + 1 windows."""
    _, gen = gens()
    ref_texts, ref_st = plain_runs[6, torch.float32]
    ref_eng = port_engine(setup)
    rst = ref_eng.new_stream(cache_len=512)
    eng = port_engine(setup, SpecConfig(k_draft=4, fused=False))
    oracle = eng.spec_draft_source = OracleDraft(4)
    st = eng.new_stream(cache_len=512)
    t = 0.0
    for i in range(3):
        t0, t1 = (0.0, 3.0) if i == 0 else (t, t + 1.0)
        args = (synth_frames(6 if i == 0 else 2, seed=1 + i), t0, t1, "describe" if i == 0 else None,
                gen)
        before = len(rst.past_ids)
        ref_text = ref_eng.chunk_step(rst, *args)
        n_prompt = ref_eng.chunk_log[-1].prompt_tokens
        oracle.expected = rst.past_ids[before + n_prompt:] + [rst.last_token]
        oracle.base = len(st.past_ids) + n_prompt
        assert eng.chunk_step(st, *args) == ref_text == ref_texts[i]
        assert eng.chunk_log[-1].windows <= math.ceil(gen.max_new_tokens / 5) + 1
        t = t1
    assert st.past_ids == ref_st.past_ids and st.length == ref_st.length


def test_adversarial_drafts(setup, plain_runs):
    """Drafts that always miss (or hit eos): the plain engine's output."""
    _, gen = gens()
    eng = port_engine(setup, SpecConfig(k_draft=4, fused=False))
    eng.spec_draft_source = AdversarialDraft(4)
    out = run_stream(eng, gen)
    assert_same_session(out, plain_runs[6, torch.float32])
    # a miss ends a window after its first token; a hit is the eos, which ends the chunk
    assert [r.windows for r in eng.chunk_log] == [r.generated_tokens for r in eng.chunk_log]


@pytest.mark.parametrize("fused", [True, False])
def test_max_new_tokens_one(setup, fused):
    spec = SpecConfig(k_draft=3, fused=fused, adaptive=False)
    jgen, gen = gens(max_new_tokens=1)
    out = run_stream(port_engine(setup, spec), gen)
    assert_same_session(out, run_stream(port_engine(setup), gen))
    assert_same_session(out, run_stream(jax_engine(setup, spec), jgen), hist=fused)


@pytest.mark.parametrize("fused", [True, False])
def test_eos_stops_a_chunk(setup, fused):
    """The chunk's first greedy token made the eos: every path emits it and stops."""
    _, g1 = gens(max_new_tokens=1)
    eng = port_engine(setup)
    st = eng.new_stream(cache_len=512)
    eng.chunk_step(st, synth_frames(6, seed=1), 0.0, 3.0, "describe", g1)
    jgen, gen = gens(eos_token_id=st.last_token)
    spec = SpecConfig(k_draft=3, fused=fused, adaptive=False)
    ref_eng = port_engine(setup)
    ref = run_stream(ref_eng, gen, n_chunks=2)
    eng = port_engine(setup, spec)
    out = run_stream(eng, gen, n_chunks=2)
    assert_same_session(out, ref)
    assert_same_session(out, run_stream(jax_engine(setup, spec), jgen, n_chunks=2), hist=fused)
    assert ref_eng.chunk_log[0].generated_tokens == 1 and eng.chunk_log[0].generated_tokens == 1


@pytest.mark.parametrize("off,sink,keep", [(60, 8, 16), (20, 8, 16), (64, 0, 32), (5, 8, 64)])
def test_compact_token_row_matches_jax(off, sink, keep):
    hist = np.random.RandomState(off).randint(-1, 50, size=(3, 64)).astype(np.int32)
    ref = jax_compact_token_row(jnp.asarray(hist), jnp.int32(off), jnp.int32(1), jnp.int32(sink),
                                jnp.int32(keep))
    out = torch.from_numpy(hist.copy())
    ptr = out.data_ptr()
    assert compact_token_row(out, off, 1, sink, keep) is out and out.data_ptr() == ptr
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_lookahead_across_compaction(setup):
    """Fused lookahead over the session horizon: the shadow is compacted with
    the cache, and the output stays JAX's and the plain engine's."""
    kw = dict(cache_len=256, compact_keep=96, compact_sink_cap=64)
    spec = SpecConfig(k_draft=3, adaptive=False)
    jgen, gen = gens(max_new_tokens=4)
    ref = run_stream(jax_engine(setup, spec, **kw), jgen, n_chunks=6, stream_cache_len=256)
    plain_eng = port_engine(setup, **kw)
    plain = run_stream(plain_eng, gen, n_chunks=6, stream_cache_len=256)
    out = run_stream(port_engine(setup, spec, **kw), gen, n_chunks=6, stream_cache_len=256)
    assert sum(r.dropped_tokens for r in plain_eng.chunk_log) > 0, "must cross the horizon"
    assert_same_session(out, plain)
    assert_same_session(out, ref, hist=True)
    assert out[1].hist[0, :out[1].length].min() >= 0, "the shadow must be fully populated"


def test_lookahead_int8_cache(setup, plain_runs):
    spec = SpecConfig(k_draft=3, adaptive=False)
    jgen, gen = gens(max_new_tokens=5)
    out = run_stream(port_engine(setup, spec, cache_dtype=torch.int8), gen)
    assert_same_session(out, plain_runs[5, torch.int8])
    assert_same_session(out, run_stream(jax_engine(setup, spec, cache_dtype=jnp.int8), jgen),
                        hist=True)


@pytest.mark.parametrize("fused", [True, False])
def test_sampling_mode_runs(setup, fused):
    """do_sample through both loops: real vocab ids and a consistent
    state. Sampling matches JAX only in distribution, so no tokens are
    compared."""
    _, gen = gens(do_sample=True, temperature=0.9, top_k=20)
    texts, st = run_stream(port_engine(setup, SpecConfig(k_draft=3, fused=fused)), gen,
                           n_chunks=2)
    assert len(texts) == 2 and st.length > 0
    assert all(0 <= t < setup["cfg"].text.vocab_size for t in st.past_ids)


# -- the controller -------------------------------------------------------------

def script(ctl_cls, spec_cls):
    """One scripted sequence of decisions and walls: bootstrap, plain faster,
    probes, a regime shift back, the stall clip, ``force``."""
    ctl = ctl_cls(spec_cls(k_draft=8, ema=0.5, probe_every=4))
    trace = []
    walls = {True: [0.9, 0.8, 0.3, 0.3, 0.3, 0.25, 9.0, 0.3], False: [0.7, 0.6, 0.65]}
    for i in range(24):
        use = ctl.use_spec()
        seq = walls[use]
        ctl.observe_wall(use, seq[i % len(seq)], 16)
        if use:
            ctl.observe(16 + i, 2, 3)
        trace.append((use, ctl.spt[True], ctl.spt[False], ctl.enabled, ctl.ema))
    ctl.force = False
    trace.append((ctl.use_spec(), ctl.last_choice))
    off = ctl_cls(spec_cls(adaptive=False))
    trace.append([off.use_spec() for _ in range(3)])
    trace.append(ctl_cls(None).use_spec())
    return trace


def test_spec_controller_matches_jax():
    assert script(SpecController, SpecConfig) == script(jspec.SpecController, jspec.SpecConfig)


# -- the step over fixed buffers and the card's loop ----------------------------

NB, SMAX, SB = 3, 64, 5
OFFSETS = np.asarray([20, 9, 31], np.int32)
DELTAS = np.asarray([[0], [2], [-1]], np.int32)
VALID = np.asarray([5, 3, 4], np.int32)


@pytest.fixture(scope="module")
def step_inputs(setup):
    """A B = 3 lookahead chunk: a seeded cache, prompt ids already prefilled
    at each row's offset, prefill logits and counts, rows at different
    offsets with prompts of different lengths. A probe (no eos, no
    threshold) gives each row's greedy chain; rows 0 and 2 get that chain
    planted early in their history, so their drafts hit; row 1 meets its
    eos at step 3, and row 2's streaming eos (its step-2 token) is masked
    from step 1 by the ramp, so its chain leaves the planted one."""
    cfg, model = setup["cfg"], setup["model"]
    rng = np.random.RandomState(0)
    vocab = cfg.text.vocab_size
    inp = dict(logits0=rng.randn(NB, vocab).astype(np.float32),
               counts=rng.randint(0, 2, size=(NB, vocab)).astype(np.int32),
               hist=np.full((NB, SMAX), -1, np.int32),
               prompt=rng.randint(10, 20, size=(NB, SB)).astype(np.int32))
    g = torch.Generator().manual_seed(0)
    inp["k"] = torch.randn((cfg.text.num_hidden_layers, NB, cfg.text.num_key_value_heads, SMAX,
                            cfg.text.head_dim), generator=g)
    inp["v"] = torch.randn(inp["k"].shape, generator=g)
    probe = GenerationParams(max_new_tokens=8, eos_token_id=-1, pad_token_id=0,
                             repetition_penalty=1.05)
    chain = decode_chunk_lookahead_plain(model, cfg, probe, SpecConfig(k_draft=3),
                                         *port_step_args(inp))[0].numpy()
    inp["hist"][0, 2:10] = chain[0]
    inp["hist"][2, 3:11] = chain[2]
    gen = dict(max_new_tokens=8, eos_token_id=int(chain[1, 3]), pad_token_id=0,
               repetition_penalty=1.05, streaming_eos_token_id=int(chain[2, 2]),
               streaming_threshold_base=0.0, streaming_threshold_step=0.25)
    return inp, gen


def port_step_args(inp):
    cache = KVCache(inp["k"].clone(), inp["v"].clone(), torch.from_numpy(OFFSETS.copy()))
    return (torch.from_numpy(inp["prompt"]), torch.from_numpy(VALID),
            torch.from_numpy(inp["logits0"]), cache, torch.from_numpy(inp["hist"].copy()),
            torch.from_numpy(inp["counts"].copy()), torch.from_numpy(DELTAS))


def card_loop(model, cfg, gen, spec, prompt, valid, logits0, cache, hist, counts, delta,
              active=None):
    """The card's control flow on the CPU: ``run_steps`` over one
    ``LookaheadState``, the step run eagerly, the flag read from ``st.done``."""
    st = LookaheadState.empty(NB, logits0.shape[1], gen.max_new_tokens, "cpu")
    lookahead_prologue(st, gen, prompt, valid, logits0, cache, hist, counts, delta, None, active)
    run_steps(gen.max_new_tokens - 1,
              lambda _i: lookahead_step(model, cfg, gen, spec, st, cache, hist), lambda: bool(st.done))
    return lookahead_epilogue(st, cache, hist, counts)


@pytest.mark.parametrize("case", ["ramp", "inactive"])
@pytest.mark.parametrize("loop", ["plain", "card"])
def test_lookahead_step_matches_jax(setup, step_inputs, case, loop):
    """JAX ``decode_chunk_lookahead`` on the same inputs: tokens, counts,
    offsets, windows, the shadow below each row's new offset and the cache
    writes there; a ramping streaming threshold, rows stopping apart, an
    inactive row. The card's loop (step 0 always, then while the flag is
    clear) gives what the plain loop gives."""
    cfg, model = setup["cfg"], setup["model"]
    inp, fields = step_inputs
    spec = SpecConfig(k_draft=3, adaptive=False)
    active = [True, False, True] if case == "inactive" else None
    jcache = jm.KVCache(jnp.asarray(inp["k"].numpy()), jnp.asarray(inp["v"].numpy()),
                        jnp.asarray(OFFSETS))
    ref = jspec.decode_chunk_lookahead(
        setup["params"], setup["jcfg"], JaxGenerationParams(**fields),
        jspec.SpecConfig(k_draft=3, adaptive=False), jnp.asarray(inp["prompt"]),
        jnp.asarray(VALID), jnp.asarray(inp["logits0"]), jcache, jnp.asarray(inp["hist"]),
        jnp.asarray(inp["counts"]), jnp.asarray(DELTAS), jax.random.PRNGKey(0),
        active=None if active is None else jnp.asarray(active))
    jt, jn, jcache, jhist, jc, jiters = (np.asarray(x) if not isinstance(x, jm.KVCache) else x
                                         for x in ref)
    args = port_step_args(inp)
    run = decode_chunk_lookahead_plain if loop == "plain" else card_loop
    tokens, n_gen, cache, hist, counts, n_iters = run(
        model, cfg, GenerationParams(**fields), spec, *args,
        active=None if active is None else torch.tensor(active))
    np.testing.assert_array_equal(tokens.numpy(), jt)
    np.testing.assert_array_equal(n_gen.numpy(), jn)
    np.testing.assert_array_equal(counts.numpy(), jc)
    np.testing.assert_array_equal(cache.offset.numpy(), np.asarray(jcache.offset))
    assert int(n_iters) == int(jiters) and int(n_iters) > 0
    for b, off in enumerate(np.asarray(jcache.offset)):
        np.testing.assert_array_equal(hist[b, :off].numpy(), jhist[b, :off])
        np.testing.assert_allclose(cache.k[:, b, :, :off].numpy(),
                                   np.asarray(jcache.k)[:, b, :, :off], atol=1e-5, rtol=1e-5)
    # row 1 stops at its eos (or never runs); drafts hit, so fewer windows than tokens
    assert n_gen.tolist() == ([8, 0, 8] if case == "inactive" else [8, 4, 8])
    assert int(n_iters) < 7
    if case == "inactive":
        assert int(cache.offset[1]) == OFFSETS[1]


def test_extra_step_when_no_row_runs_changes_nothing_committed(setup, step_inputs):
    """The card always runs step 0: where no row runs on from the start (every
    row inactive) the step changes no token, count, offset or window count,
    and nothing below any row's offset."""
    cfg, model = setup["cfg"], setup["model"]
    inp = step_inputs[0]
    spec = SpecConfig(k_draft=3, adaptive=False)
    gen = GenerationParams(max_new_tokens=6, eos_token_id=3, pad_token_id=0)
    prompt, valid, logits0, cache, hist, counts, delta = port_step_args(inp)
    st = LookaheadState.empty(NB, logits0.shape[1], gen.max_new_tokens, "cpu")
    lookahead_prologue(st, gen, prompt, valid, logits0, cache, hist, counts, delta, None,
                       torch.zeros(NB, dtype=torch.bool))
    assert bool(st.done)
    before = {f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)}
    k, h = cache.k.clone(), hist.clone()
    lookahead_step(model, cfg, gen, spec, st, cache, hist)
    for name, t in before.items():
        assert torch.equal(getattr(st, name), t), name
    for b, off in enumerate(OFFSETS):
        assert torch.equal(cache.k[:, b, :, :off], k[:, b, :, :off])
        assert torch.equal(hist[b, :off], h[b, :off])


@pytest.mark.parametrize("event", ["grow", "compact"])
def test_graph_key_of_lookahead(setup, event):
    """A plain and a lookahead graph of one cache never share a key; growth
    reallocates the cache and ``hist`` (a new key), compaction writes both
    in place (the same key)."""
    spec = SpecConfig(k_draft=3, adaptive=False)
    gen = GenerationParams(max_new_tokens=4)
    eng = port_engine(setup, spec, cache_len=256, compact_keep=64, compact_sink_cap=16)
    state = eng.new_stream(cache_len=128 if event == "grow" else 256)
    state.length = 120 if event == "grow" else 250
    state.cache.offset = torch.tensor([state.length], dtype=torch.int32)
    state.rope_delta = 0
    model = eng.model
    key = lambda: graph_key(model, gen, state.cache, 1, spec=spec, hist=state.hist)
    plain = graph_key(model, gen, state.cache, 1)
    before, ptr = key(), state.hist.data_ptr()
    assert before != plain and graph_key(model, gen, state.cache, 1, spec=dataclasses.replace(
        spec, k_draft=4), hist=state.hist) != before
    eng._ensure_capacity(state, 32)
    if event == "grow":
        assert state.hist.shape == (1, 256) and key() != before
        assert (state.hist[0, 128:] == -1).all()
    else:
        assert int(state.cache.offset[0]) < 250 and state.hist.data_ptr() == ptr
        assert key() == before


# -- the serving pool -----------------------------------------------------------

# (tick, stream, resolution, query, frame seed); capacity 3 leaves one slot idle
MIXED = [
    (0, "a", (28, 28), "q", 0),
    (1, "a", (28, 28), None, 1), (1, "b", (28, 56), "late", 2),
    (2, "a", (28, 28), None, 3), (2, "b", (28, 56), None, 4),
    (3, "a", (28, 28), None, 5), (3, "b", (28, 56), None, 6),
]
LONG = [(0, "a", (28, 28), "q", 0)] + [(i, "a", (28, 28), None, i) for i in range(1, 9)]


def drive(server, traffic, snapshot_after=None, path=None):
    """``traffic`` through either package's server: {stream: [texts]}."""
    sids, spans, texts = {}, {}, {}
    for tick in sorted({t for t, *_ in traffic}):
        for t, name, res, query, seed in traffic:
            if t != tick:
                continue
            if name not in sids:
                sids[name] = server.add_stream(res, query=query)
                spans[name] = (0.0, 3.0)
                f = synth_frames(6, *res, seed=seed)
            else:
                spans[name] = (spans[name][1], spans[name][1] + 1.0)
                f = synth_frames(2, *res, seed=seed)
            server.submit_chunk(sids[name], f, *spans[name])
        server.tick()
        server.flush()
        for name, sid in sids.items():
            texts.setdefault(name, []).extend(text for _, text in server.drain(sid))
        if tick == snapshot_after:
            server.snapshot(path)
    return texts


def servers(setup, spec, dtype="float32", **kw):
    """(JAX, port) pools on the same weights, fp32 or int8 KV."""
    jd, pd = {"float32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}[dtype]
    cache_len = kw.pop("cache_len", 512)
    jgen, gen = gens(max_new_tokens=4)
    return (JaxStreamServer(jax_engine(setup, spec, jd, cache_len=cache_len), jgen, **kw),
            StreamServer(port_engine(setup, spec, pd, cache_len=cache_len), gen, **kw))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pool_spec_matches_jax_and_plain(setup, dtype):
    """Capacity 3 with an idle slot, a late joiner and two resolution classes:
    the port's lookahead pool == JAX's == the port's plain pool; every tick
    ran lookahead, and the pool's shadow mirrors JAX's over each row's
    committed history."""
    spec = SpecConfig(k_draft=3, adaptive=False)
    jserver, server = servers(setup, spec, dtype, capacity=3)
    ref = drive(jserver, MIXED)
    out = drive(server, MIXED)
    plain = drive(servers(setup, None, dtype, capacity=3)[1], MIXED)
    assert out == ref == plain
    assert len(out["a"]) == 4 and len(out["b"]) == 3
    assert server._ctl().last_choice
    for s in server._streams.values():
        off = int(server.pool_caches.offset[s.slot])
        np.testing.assert_array_equal(server.pool_hist[s.slot, :off].numpy(),
                                      np.asarray(jserver.pool_hist)[s.slot, :off])


def test_pool_spec_compaction_and_restore(setup, tmp_path):
    """A stream across the pool's horizon (its shadow compacted with its
    cache), snapshotted after tick 4 and restored into a fresh pool: the
    restored shadow is the snapshotted one, the texts are JAX's and the
    uninterrupted session's, and the snapshot holds JAX's hist row."""
    spec = SpecConfig(k_draft=3, adaptive=False)
    kw = dict(cache_len=256, compact_keep=64, compact_sink_cap=32)
    jserver, server = servers(setup, spec, **kw)
    jpath, path = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    ref = drive(jserver, LONG, snapshot_after=4, path=jpath)
    out = drive(server, LONG, snapshot_after=4, path=path)
    assert out == ref
    dropped = server.engine.metrics.summary("cache_compaction_dropped_tokens")
    assert dropped.get("n", 0) >= 1
    snap, jsnap = np.load(path), np.load(jpath)
    np.testing.assert_array_equal(snap["hist_0"], jsnap["hist_0"])
    # restore tick 4's state into a fresh pool and run ticks 5-8 there
    fresh = servers(setup, spec, **kw)[1]
    [sid] = fresh.restore(path)
    slot = fresh._streams[sid].slot
    np.testing.assert_array_equal(fresh.pool_hist[slot].numpy(), snap["hist_0"])
    spans = (7.0, 8.0)
    texts = []
    for t, _, res, _, seed in LONG[5:]:
        fresh.submit_chunk(sid, synth_frames(2, *res, seed=seed), *spans)
        spans = (spans[1], spans[1] + 1.0)
        fresh.tick()
        texts.extend(text for _, text in fresh.drain(sid))
    assert texts == out["a"][5:]

"""The port's decode step over fixed buffers against JAX ``decode_chunk``.

The card replays one captured ``decode_step`` per chunk step
(``livecc_tpu_torch/engine/graphs.py``); here, on the CPU, the same step runs
eagerly. Both the plain loop (``decode_chunk_plain``) and the card's loop
(``graphs.run_steps``: step 0 always, then one step while the stop flag read
after each step is clear) are held to the JAX while-loop on the tiny config,
fp32, with the step index and its streaming threshold on the device. One JAX
run per case is shared through a module fixture.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.engine import GenerationParams as JaxGenerationParams
from livecc_tpu.engine.generation import decode_chunk as jax_decode_chunk
from livecc_tpu.models import qwen2_vl as jm

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.engine import GenerationParams, LiveCCEngine
from livecc_tpu_torch.engine.generation import (
    DecodeState, decode_chunk, decode_chunk_plain, decode_epilogue, decode_prologue, decode_step)
from livecc_tpu_torch.engine.graphs import graph_key, run_steps
from livecc_tpu_torch.models.qwen2_vl import KVCache, params_from_jax
from livecc_tpu_torch.serve import StreamServer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, SMAX = 3, 64
OFFSETS = np.asarray([8, 3, 11], np.int32)
DELTAS = np.asarray([[0], [2], [-1]], np.int32)
# rows stop apart (row 1 at step 0, row 0 at step 3, row 2 runs on) and the
# streaming threshold ramps 0 -> 0.5 -> 1.0 over the steps (``tiny``)
CASES = {
    "ramp-6": dict(max_new_tokens=6, active=None),
    "ramp-1": dict(max_new_tokens=1, active=None),
    "inactive-6": dict(max_new_tokens=6, active=[True, False, True]),
}


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = jax_tiny_config(), tiny_config()
    params = jm.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg)
    rng = np.random.RandomState(0)
    logits0 = rng.randn(B, cfg.text.vocab_size).astype(np.float32)
    counts = rng.randint(0, 2, size=(B, cfg.text.vocab_size)).astype(np.int32)
    # with no eos and no threshold, which tokens each row's greedy path emits
    probe = GenerationParams(max_new_tokens=6, eos_token_id=-1, pad_token_id=cfg.pad_token_id,
                             repetition_penalty=1.05)
    tokens = decode_chunk(model, cfg, probe, torch.from_numpy(logits0), port_cache(cfg),
                          torch.from_numpy(counts.copy()), torch.from_numpy(DELTAS))[0]
    eos = int(tokens[0, 3])                 # row 0 stops at step 3
    logits0[1, eos] = 10.0                  # row 1 at step 0
    gen = dict(eos_token_id=eos, pad_token_id=cfg.pad_token_id, repetition_penalty=1.05,
               streaming_eos_token_id=int(tokens[2, 2]),       # masked in row 2 from step 1
               streaming_threshold_base=0.0, streaming_threshold_step=0.5)
    return dict(jcfg=jcfg, cfg=cfg, params=params, model=model, logits0=logits0,
                counts=counts, gen=gen)


def port_cache(cfg):
    cache = KVCache.zeros(cfg.text, B, SMAX)
    g = torch.Generator().manual_seed(1)
    cache.k.normal_(generator=g)
    cache.v.normal_(generator=g)
    cache.offset = torch.from_numpy(OFFSETS.copy())
    return cache


def port_inputs(tiny, case):
    cfg = tiny["cfg"]
    gen = GenerationParams(max_new_tokens=CASES[case]["max_new_tokens"], **tiny["gen"])
    active = CASES[case]["active"]
    active = None if active is None else torch.tensor(active)
    return (gen, torch.from_numpy(tiny["logits0"]), port_cache(cfg),
            torch.from_numpy(tiny["counts"].copy()), torch.from_numpy(DELTAS), active)


@pytest.fixture(scope="module")
def jax_runs(tiny):
    """JAX ``decode_chunk`` on each case: tokens, n_gen, counts, offsets, K."""
    out = {}
    for case, spec in CASES.items():
        jcache = jm.KVCache.zeros(tiny["jcfg"].text, B, SMAX)
        pc = port_cache(tiny["cfg"])
        jcache = jm.KVCache(jax.numpy.asarray(pc.k.numpy()), jax.numpy.asarray(pc.v.numpy()),
                            jax.numpy.asarray(OFFSETS))
        active = spec["active"]
        jt, jn, jcache, jc = jax_decode_chunk(
            tiny["params"], tiny["jcfg"],
            JaxGenerationParams(max_new_tokens=spec["max_new_tokens"], **tiny["gen"]),
            jax.numpy.asarray(tiny["logits0"]), jcache, jax.numpy.asarray(tiny["counts"]),
            jax.numpy.asarray(DELTAS), jax.random.PRNGKey(0),
            active=None if active is None else jax.numpy.asarray(active))
        out[case] = [np.asarray(x) for x in (jt, jn, jc, jcache.offset, jcache.k)]
    return out


def card_loop(model, cfg, gen, logits0, cache, counts, rope_delta, active, st=None):
    """The card's control flow on the CPU: ``run_steps`` over one
    ``DecodeState`` (reused when given, as a graph's buffers are), the step
    run eagerly, the stop flag read from ``st.done``."""
    if st is None:
        st = DecodeState.empty(logits0.shape[0], logits0.shape[1], gen.max_new_tokens, "cpu")
    decode_prologue(st, gen, logits0, cache, counts, rope_delta, active)
    n = run_steps(gen.max_new_tokens - 1, lambda _i: decode_step(model, cfg, gen, st, cache),
                  lambda: bool(st.done))
    return (*decode_epilogue(st, gen, cache, counts), n)


def assert_matches(out, ref, cache):
    tokens, n_gen, cache_out, counts = out[:4]
    jt, jn, jc, joff, jk = ref
    np.testing.assert_array_equal(tokens.numpy(), jt)
    np.testing.assert_array_equal(n_gen.numpy(), jn)
    np.testing.assert_array_equal(counts.numpy(), jc)
    np.testing.assert_array_equal(cache_out.offset.numpy(), joff)
    for row, off in enumerate(joff):      # forwarded K below each row's new offset
        np.testing.assert_allclose(cache.k[:, row, :, :off].numpy(), jk[:, row, :, :off],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("loop", ["plain", "card"])
def test_decode_step_matches_jax(tiny, jax_runs, case, loop):
    """Rows that stop apart under a ramping threshold, an inactive row, and
    max_new_tokens of 1 and 6: the plain loop and the card's loop give JAX's
    tokens, counts, offsets and cache writes."""
    gen, logits0, cache, counts, delta, active = port_inputs(tiny, case)
    run = decode_chunk_plain if loop == "plain" else card_loop
    out = run(tiny["model"], tiny["cfg"], gen, logits0, cache, counts, delta, active=active)
    assert_matches(out, jax_runs[case], cache)
    if case == "ramp-6":
        n_gen = out[1].tolist()
        assert n_gen == [4, 1, 6]                                    # the rows stop apart
    if case == "inactive-6":
        assert out[1].tolist()[1] == 0 and int(out[2].offset[1]) == OFFSETS[1]


def test_frozen_step_index_changes_the_tokens(tiny, jax_runs, monkeypatch):
    """The threshold reads the step counter: with the index it sees held at
    0 the ramp never masks the streaming eos, and the tokens differ from
    JAX's."""
    from livecc_tpu_torch.engine import generation

    adjust = generation.adjust_logits
    monkeypatch.setattr(generation, "adjust_logits", lambda lg, c, g, _i: adjust(lg, c, g, 0))
    gen, logits0, cache, counts, delta, active = port_inputs(tiny, "ramp-6")
    frozen = decode_chunk_plain(tiny["model"], tiny["cfg"], gen, logits0, cache, counts, delta,
                                active=active)[0]
    assert not np.array_equal(frozen.numpy(), jax_runs["ramp-6"][0])


def test_buffers_reused_across_chunks_match_the_plain_loop(tiny):
    """The card keeps one ``DecodeState`` per graph across chunks: two
    chunks on the same buffers give what two plain-loop chunks give."""
    model, cfg = tiny["model"], tiny["cfg"]
    outs = []
    for reuse in (False, True):
        gen, logits0, cache, counts, delta, active = port_inputs(tiny, "ramp-6")
        st = DecodeState.empty(B, logits0.shape[1], gen.max_new_tokens, "cpu") if reuse else None
        chunk = []
        for _ in range(2):
            if reuse:
                out = card_loop(model, cfg, gen, logits0, cache, counts, delta, active, st)
            else:
                out = decode_chunk_plain(model, cfg, gen, logits0, cache, counts, delta,
                                         active=active)
            chunk.append([x.clone() for x in (out[0], out[1], out[3], out[2].offset)])
            logits0 = logits0.roll(1, dims=-1)     # the next chunk's prefill logits
        outs.append(chunk + [cache.k.clone()])
    for a, b in zip(outs[0][:2], outs[1][:2]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert torch.equal(outs[0][2], outs[1][2])


def test_extra_step_after_all_stopped_changes_nothing(tiny):
    """Once every row has stopped, one more step (what the card runs when a
    chunk starts with every row stopped) changes no token, count or offset,
    no cache position below any row's offset, and not the chunk's output."""
    model, cfg = tiny["model"], tiny["cfg"]
    gen, logits0, cache, counts, delta, _ = port_inputs(tiny, "ramp-6")
    gen = dataclasses.replace(gen, streaming_threshold_base=-1.0)
    st = DecodeState.empty(B, logits0.shape[1], gen.max_new_tokens, "cpu")
    decode_prologue(st, gen, logits0, cache, counts, delta, torch.tensor([True, True, False]))
    steps = 0
    while not bool(st.stopped.all()):
        decode_step(model, cfg, gen, st, cache)
        steps += 1
    assert steps < gen.max_new_tokens - 1, "every row should stop before the last step"
    before = {f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)}
    k, v = cache.k.clone(), cache.v.clone()
    ref = decode_epilogue(dataclasses.replace(st, **{n: t.clone() for n, t in before.items()}),
                          gen, dataclasses.replace(cache), counts.clone())
    decode_step(model, cfg, gen, st, cache)
    for name in ("tokens", "emitted", "counts", "offset", "stopped"):
        assert torch.equal(getattr(st, name), before[name]), name
    for row, off in enumerate(st.offset.tolist()):
        assert torch.equal(cache.k[:, row, :, :off], k[:, row, :, :off])
        assert torch.equal(cache.v[:, row, :, :off], v[:, row, :, :off])
    out = decode_epilogue(st, gen, cache, counts)
    for a, b in zip((out[0], out[1], out[3], out[2].offset),
                    (ref[0], ref[1], ref[3], ref[2].offset)):
        assert torch.equal(a, b)


def _engine(cache_len, **kw):
    cfg = tiny_config()
    model = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax_tiny_config(), jax.random.PRNGKey(0))), cfg)
    return LiveCCEngine(model, cfg, ByteTokenizer(), cache_len=cache_len, **kw)


@pytest.mark.parametrize("event", ["grow", "engine_compact", "server_compact"])
def test_graph_key_follows_the_cache_storage(event):
    """A graph bakes in the cache's addresses: growth reallocates the cache
    (a new key, the old graph dropped with its buffers); compaction evicts
    in place (``compact_cache_row``), so the storage and the key stay and
    the graph remains valid."""
    gen = GenerationParams(max_new_tokens=4)
    if event == "server_compact":
        server = StreamServer(_engine(256), gen, capacity=2, compact_keep=64, compact_sink_cap=16)
        server._ensure_pool()
        server.pool_caches.offset = torch.tensor([200, 10], dtype=torch.int32)
        sid = server.add_stream((28, 28))
        server._streams[sid].slot = 0
        server._streams[sid].rope_delta = 0
        model, cache_of = server.engine.model, lambda: server.pool_caches
        change = lambda: server._compact(server._streams[sid])
    else:
        eng = _engine(256, compact_keep=64, compact_sink_cap=16)
        state = eng.new_stream(cache_len=128 if event == "grow" else 256)
        state.length = 120 if event == "grow" else 250
        state.cache.offset = torch.tensor([state.length], dtype=torch.int32)
        state.rope_delta = 0
        model, cache_of = eng.model, lambda: state.cache
        change = lambda: eng._ensure_capacity(state, 32)
    cache = cache_of()
    batch = cache.k.shape[1]
    key, ptr, offset = graph_key(model, gen, cache, batch), cache.k.data_ptr(), cache.offset.clone()
    change()
    after = cache_of()
    if event == "grow":
        assert (cache.max_len, after.max_len) == (128, 256)
        assert graph_key(model, gen, after, batch) != key
    else:
        assert int(after.offset[0]) < int(offset[0])            # the middle was evicted
        assert after.k.data_ptr() == ptr and graph_key(model, gen, after, batch) == key

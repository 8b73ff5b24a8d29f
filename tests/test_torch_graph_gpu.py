"""The card's decode graphs against the eager plain loop, on a bf16 tiny model.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) where
``torch.cuda.is_available()`` is false. On a machine with the card (which
has no jax, so ``tests/conftest.py`` stays out):

    python -m pytest --noconftest -m gpu tests/test_torch_graph_gpu.py -q

``decode_chunk`` on CUDA tensors replays the model's captured decode step
(``livecc_tpu_torch/engine/graphs.py``); ``decode_chunk_plain`` runs the
same step eagerly, one host read of the stop flags per step. Greedy decoding
must give the same tokens, counts, offsets and cache writes, and the same
kernel launch counts (replays counted).
"""

import collections

import numpy as np
import pytest
import torch

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.engine import GenerationParams, LiveCCEngine, streaming
from livecc_tpu_torch.engine.generation import (
    adjust_logits, decode_chunk, decode_chunk_plain, select_token)
from livecc_tpu_torch.engine.graphs import graphs_for
from livecc_tpu_torch.models.qwen2_vl import KVCache, init_params
from livecc_tpu_torch.ops import build
from livecc_tpu_torch.ops.attention import NEG_INF

pytestmark = pytest.mark.gpu
B, SMAX = 3, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: python -m pytest -m gpu "
                    "tests/test_torch_graph_gpu.py)")
    return torch.device("cuda")


@pytest.fixture
def tiny(cuda):
    cfg = tiny_config()
    return cfg, init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda,
                            torch.bfloat16)


def start(cfg, dev, seed=0, quant=False):
    """(logits0, cache, counts, rope_delta) of a B = 3 decode at depths 8, 3, 11."""
    g = torch.Generator(device=dev).manual_seed(seed)
    v = cfg.text.vocab_size
    logits0 = torch.randn((B, v), generator=g, device=dev) * 3
    counts = torch.randint(0, 2, (B, v), generator=g, device=dev, dtype=torch.int32)
    cache = KVCache.zeros(cfg.text, B, SMAX, torch.int8 if quant else torch.bfloat16, dev)
    if quant:
        cache.k.random_(-100, 100, generator=g)
        cache.v.random_(-100, 100, generator=g)
        cache.k_scale.uniform_(0.001, 0.02, generator=g)
        cache.v_scale.uniform_(0.001, 0.02, generator=g)
    else:
        cache.k.normal_(generator=g)
        cache.v.normal_(generator=g)
    cache.offset = torch.tensor([8, 3, 11], dtype=torch.int32, device=dev)
    delta = torch.tensor([[0], [2], [-1]], dtype=torch.int32, device=dev)
    return logits0, cache, counts, delta


def clone(cache):
    return KVCache(*(None if t is None else t.clone()
                     for t in (cache.k, cache.v, cache.offset, cache.k_scale, cache.v_scale)))


def run(fn, model, cfg, gen, logits0, cache, counts, delta, active=None, chunks=2):
    """``chunks`` decodes in a row (the next starting from the last's
    cache, counts and rolled logits); their outputs and launch counts."""
    build.reset_launch_counts()
    outs = []
    for _ in range(chunks):
        tokens, n_gen, cache, counts = fn(model, cfg, gen, logits0, cache, counts, delta,
                                          active=active)
        outs.append((tokens.clone(), n_gen.clone(), counts.clone(), cache.offset.clone()))
        logits0 = logits0.roll(7, dims=-1)
    torch.cuda.synchronize()
    return outs, cache, collections.Counter({k: n for k, n in build.launch_counts.items() if n})


@pytest.mark.parametrize("case", ["stop-apart", "inactive", "int8", "one-token"])
def test_graph_replay_matches_the_plain_loop(tiny, case):
    """Greedy: the same tokens, counts, offsets and cache writes as the
    plain loop over two chunks (a capture, then replays), and the same
    launch counts; rows stop apart under a ramping streaming threshold."""
    cfg, model = tiny
    dev = model.text.embed.weight.device
    logits0, cache, counts, delta = start(cfg, dev, quant=case == "int8")
    probe = GenerationParams(max_new_tokens=6, eos_token_id=-1, pad_token_id=0,
                             repetition_penalty=1.05)
    tokens = decode_chunk_plain(model, cfg, probe, logits0, clone(cache), counts.clone(),
                                delta)[0]
    eos = int(tokens[0, 3])
    logits0[1, eos] = 50.0
    gen = GenerationParams(max_new_tokens=1 if case == "one-token" else 6, eos_token_id=eos,
                           pad_token_id=0, repetition_penalty=1.05,
                           streaming_eos_token_id=int(tokens[2, 2]),
                           streaming_threshold_base=0.0, streaming_threshold_step=0.5)
    active = torch.tensor([True, False, True], device=dev) if case == "inactive" else None
    graphs = graphs_for(model, cfg)
    graphs.reset_stats()
    a, cache_a, launches_a = run(decode_chunk, model, cfg, gen, logits0, clone(cache),
                                 counts.clone(), delta, active)
    stats = graphs.stats()
    b, cache_b, launches_b = run(decode_chunk_plain, model, cfg, gen, logits0, clone(cache),
                                 counts.clone(), delta, active)
    for x, y in zip(a, b):
        for u, w in zip(x, y):
            assert torch.equal(u, w)
    assert torch.equal(cache_a.k, cache_b.k) and torch.equal(cache_a.v, cache_b.v)
    assert launches_a == launches_b
    if case == "one-token":
        assert stats["captures"] == 0 and stats["replays"] == 0
        return
    name = "flash_decode_int8" if case == "int8" else "flash_decode"
    assert launches_a[name] > 0
    assert stats["captures"] == 1 and stats["replays"] > 0
    if case == "stop-apart":
        n_gen = a[0][1].tolist()
        assert n_gen[1] == 1 and len(set(n_gen)) > 1
    if case == "inactive":
        assert a[0][1].tolist()[1] == 0


def test_replay_loop_makes_no_synchronizing_call(tiny):
    """Once captured, a chunk decodes with ``set_sync_debug_mode("error")``
    on: the stop flag travels through pinned memory and a polled event,
    nothing else reaches the host. The plain loop, which reads the flags
    with ``bool(tensor)``, trips the same mode."""
    cfg, model = tiny
    dev = model.text.embed.weight.device
    logits0, cache, counts, delta = start(cfg, dev)
    gen = GenerationParams(max_new_tokens=8, eos_token_id=-1, pad_token_id=0)
    graphs = graphs_for(model, cfg)
    decode_chunk(model, cfg, gen, logits0, cache, counts, delta)        # the capture
    torch.cuda.synchronize()
    graphs.reset_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode_chunk(model, cfg, gen, logits0, cache, counts, delta)
        with pytest.raises(RuntimeError):
            decode_chunk_plain(model, cfg, gen, logits0, cache, counts, delta)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    st = graphs.stats()
    assert (st["captures"], st["replays"], st["host_reads"]) == (0, 7, 6)


def synth(n, seed):
    return np.random.RandomState(seed).randint(0, 256, size=(n, 28, 28, 3), dtype=np.uint8)


def test_engine_recaptures_after_growth_not_after_compaction(tiny, monkeypatch):
    """A session whose cache doubles once and then compacts: the graph
    engine and the plain-loop engine give the same text and history; the
    graphs are captured once per cache storage (the first and the grown
    one), and the stale one is dropped."""
    cfg, model = tiny
    gen = GenerationParams(max_new_tokens=4, eos_token_id=3, pad_token_id=0,
                           repetition_penalty=1.05)
    graphs = graphs_for(model, cfg)
    sessions = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(streaming, "decode_chunk", decode_chunk_plain)
        eng = LiveCCEngine(model, cfg, ByteTokenizer(), cache_len=512, compact_keep=96,
                           compact_sink_cap=64)
        st = eng.new_stream(cache_len=256)
        graphs.reset_stats()
        texts = [eng.chunk_step(st, synth(6, 0), 0.0, 3.0, "q", gen)]
        for i in range(13):
            texts.append(eng.chunk_step(st, synth(2, i + 1), 3.0 + i, 4.0 + i, None, gen))
        sessions.append((texts, st.past_ids, st.length, graphs.stats(),
                         sum(r.dropped_tokens for r in eng.chunk_log)))
    (t_a, ids_a, len_a, stats, dropped), (t_b, ids_b, len_b, _, _) = sessions
    assert (t_a, ids_a, len_a) == (t_b, ids_b, len_b)
    assert dropped > 0                                   # it compacted
    assert stats["captures"] == 2                        # 256, then the grown 512
    assert stats["graphs"] == 1                          # the 256 graph is gone


def allowed(logits, counts, gen, step):
    """The token set top-k / top-p leaves at ``step``: [B, V] bool."""
    lg = adjust_logits(logits, counts, gen, step) / gen.temperature
    kth = torch.sort(lg, dim=-1).values[:, -gen.top_k][:, None]
    lg = torch.where(lg < kth, torch.full_like(lg, NEG_INF), lg)
    sorted_lg = torch.sort(lg, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_lg, dim=-1), dim=-1)
    cutoff = torch.gather(sorted_lg, -1, torch.sum(cum < gen.top_p, dim=-1)[:, None])
    return lg >= cutoff


def test_sampling_replays_draw_new_numbers(tiny):
    """With ``do_sample`` the graph draws from the caller's generator, which
    it registers: a replayed ``select_token`` stays within top-k / top-p and
    draws new numbers on every replay; whole decodes from one starting state
    start within the set and differ from one another."""
    cfg, model = tiny
    dev = model.text.embed.weight.device
    logits0, cache, counts, delta = start(cfg, dev)
    gen = GenerationParams(max_new_tokens=6, eos_token_id=-1, pad_token_id=0, do_sample=True,
                           temperature=0.9, top_k=40, top_p=0.9, repetition_penalty=1.05)
    generator = torch.Generator(device=dev).manual_seed(3)
    ok = allowed(logits0, counts, gen, 0)
    # one select_token under a graph, replayed
    lg = adjust_logits(logits0, counts, gen, 0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        select_token(lg, gen, generator)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        with torch.cuda.graph(graph, stream=side):
            drawn = select_token(lg, gen, generator)
    torch.cuda.current_stream().wait_stream(side)
    draws = []
    for _ in range(20):
        graph.replay()
        draws.append(drawn.clone())
    draws = torch.stack(draws)                                           # [20, B]
    assert bool(ok.gather(1, draws.T.long()).all())
    assert len({tuple(d.tolist()) for d in draws}) > 1
    # whole decodes: the first token from logits0, within the set
    firsts = []
    for _ in range(4):
        tokens = decode_chunk(model, cfg, gen, logits0, clone(cache), counts.clone(), delta,
                              generator)[0]
        assert bool(ok.gather(1, tokens[:, :1].long()).all())
        firsts.append(tokens.clone())
    assert len({tuple(t.flatten().tolist()) for t in firsts}) > 1

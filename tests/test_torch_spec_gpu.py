"""Speculative decoding on the card: the replayed lookahead step against the
eager lookahead loop and the plain decode graphs, and K1 / K1-int8 at the
verify window's shape.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) where
``torch.cuda.is_available()`` is false. On a machine with the card (which
has no jax, so ``tests/conftest.py`` stays out):

    python -m pytest --noconftest -m gpu tests/test_torch_spec_gpu.py -q

``decode_chunk_lookahead`` on CUDA tensors replays the model's captured
``lookahead_step`` (``livecc_tpu_torch/engine/graphs.py``);
``decode_chunk_lookahead_plain`` runs the same step eagerly with one host
read of the stop flag per step. The two must give the same tokens, counts,
offsets, history and cache writes and launch counts (replays counted), and
greedy decoding must give what plain ``decode_chunk`` gives.
"""

import collections
import dataclasses

import pytest
import torch

from livecc_tpu_torch.core.config import ModelConfig, tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.engine import GenerationParams, LiveCCEngine, SpecConfig
from livecc_tpu_torch.engine.generation import decode_chunk
from livecc_tpu_torch.engine.graphs import graphs_for
from livecc_tpu_torch.engine.speculative import (
    decode_chunk_lookahead, decode_chunk_lookahead_plain)
from livecc_tpu_torch.models.qwen2_vl import KVCache, init_params
from livecc_tpu_torch.ops import build
from livecc_tpu_torch.ops.flash_attention import flash_prefill, flash_prefill_plain
from livecc_tpu_torch.tools import kernel_check, kernel_timing
from livecc_tpu_torch.tools.session import synth_frames

pytestmark = pytest.mark.gpu
B, SMAX, SB = 3, 256, 6
SPEC = SpecConfig(k_draft=3, adaptive=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: python -m pytest -m gpu "
                    "tests/test_torch_spec_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def tiny(cuda, dtype):
    cfg = tiny_config()
    return cfg, init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda, dtype)


def wide(cuda):
    """The 7B's widths with one LLM layer (and a one-block ViT), bf16."""
    cfg = ModelConfig.qwen2_vl_7b()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=1),
                              vision=dataclasses.replace(cfg.vision, depth=1))
    return cfg, init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda,
                            torch.bfloat16)


def start(cfg, dev, dtype, quant=False):
    """A B = 3 chunk after its prefill: the cache (rows 8, 3, 11 deep) with
    the prompt's ids in a history whose ids repeat, so drafts hit; the
    prefill's logits; counts; rope deltas."""
    g = torch.Generator(device=dev).manual_seed(1)
    v = cfg.text.vocab_size
    logits0 = torch.randn((B, v), generator=g, device=dev) * 3
    counts = torch.randint(0, 2, (B, v), generator=g, device=dev, dtype=torch.int32)
    cache = KVCache.zeros(cfg.text, B, SMAX, torch.int8 if quant else dtype, dev)
    if quant:
        cache.k.random_(-100, 100, generator=g)
        cache.v.random_(-100, 100, generator=g)
        cache.k_scale.uniform_(0.001, 0.02, generator=g)
        cache.v_scale.uniform_(0.001, 0.02, generator=g)
    else:
        cache.k.normal_(generator=g)
        cache.v.normal_(generator=g)
    cache.offset = torch.tensor([8, 3, 11], dtype=torch.int32, device=dev)
    prompt = torch.randint(10, 14, (B, SB), generator=g, device=dev, dtype=torch.int32)
    valid = torch.tensor([6, 3, 5], dtype=torch.int32, device=dev)
    hist = torch.full((B, SMAX), -1, dtype=torch.int32, device=dev)
    delta = torch.tensor([[0], [2], [-1]], dtype=torch.int32, device=dev)
    return dict(prompt=prompt, valid=valid, logits0=logits0, cache=cache, hist=hist,
                counts=counts, delta=delta)


def clone(x):
    if isinstance(x, KVCache):
        return KVCache(*(None if t is None else t.clone()
                         for t in (x.k, x.v, x.offset, x.k_scale, x.v_scale)))
    return x.clone()


def run(fn, model, cfg, gen, inp, chunks=2, spec=SPEC):
    """``chunks`` lookahead decodes in a row (``fn``: the graphs or the eager
    loop; None: plain ``decode_chunk``), the next from the last's cache,
    history, counts and rolled logits; outputs, final state, launch counts."""
    inp = {k: clone(v) for k, v in inp.items()}
    build.reset_launch_counts()
    outs = []
    logits0, cache, hist, counts = inp["logits0"], inp["cache"], inp["hist"], inp["counts"]
    for _ in range(chunks):
        if fn is None:
            tokens, n_gen, cache, counts = decode_chunk(model, cfg, gen, logits0, cache, counts,
                                                        inp["delta"])
        else:
            tokens, n_gen, cache, hist, counts, _ = fn(
                model, cfg, gen, spec, inp["prompt"], inp["valid"], logits0, cache, hist,
                counts, inp["delta"])
        outs.append((tokens.clone(), n_gen.clone(), counts.clone(), cache.offset.clone()))
        logits0 = logits0.roll(7, dims=-1)
    torch.cuda.synchronize()
    return outs, cache, hist, collections.Counter({k: n for k, n in build.launch_counts.items()
                                                   if n})


def assert_same(a, b):
    for x, y in zip(a, b):
        for u, w in zip(x, y):
            assert torch.equal(u, w)


@pytest.mark.parametrize("case", ["fp32", "bf16", "int8", "wide"])
def test_replayed_lookahead_matches_eager_and_plain_decode(cuda, case):
    """Two chunks: the replayed lookahead step gives the eager loop's tokens,
    counts, offsets, history and cache, with the same launch counts; both
    give plain ``decode_chunk``'s tokens (the greedy output does not depend
    on the drafts). Tiny model in fp32, bf16 and over an int8 cache; the
    7B's widths at one layer in bf16."""
    cfg, model = wide(cuda) if case == "wide" else tiny(
        cuda, torch.float32 if case == "fp32" else torch.bfloat16)
    dtype = next(model.parameters()).dtype
    inp = start(cfg, cuda, dtype, quant=case == "int8")
    gen = GenerationParams(max_new_tokens=8, eos_token_id=-1, pad_token_id=0,
                           repetition_penalty=1.05)
    graphs = graphs_for(model, cfg)
    graphs.reset_stats()
    a, cache_a, hist_a, launches_a = run(decode_chunk_lookahead, model, cfg, gen, inp)
    stats = graphs.stats()
    b, cache_b, hist_b, launches_b = run(decode_chunk_lookahead_plain, model, cfg, gen, inp)
    assert_same(a, b)
    assert torch.equal(cache_a.k, cache_b.k) and torch.equal(cache_a.v, cache_b.v)
    assert torch.equal(hist_a, hist_b)
    assert launches_a == launches_b
    name = "flash_prefill_int8" if case == "int8" else "flash_prefill"
    assert launches_a[name] > 0 and launches_a.get("flash_decode", 0) == 0
    assert stats["captures"] == 1 and stats["windows"] > 0 and stats["replays"] == 0
    plain, _, _, _ = run(None, model, cfg, gen, inp)
    for x, y in zip(a, plain):
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])


def test_replay_loop_makes_no_synchronizing_call(cuda):
    """Once captured, a chunk decodes with ``set_sync_debug_mode("error")``
    on: the stop flag travels through pinned memory and a polled event,
    nothing else reaches the host. The eager loop, which reads the flag with
    ``bool(tensor)``, trips the same mode."""
    cfg, model = tiny(cuda, torch.bfloat16)
    inp = start(cfg, cuda, torch.bfloat16)
    gen = GenerationParams(max_new_tokens=8, eos_token_id=-1, pad_token_id=0)
    graphs = graphs_for(model, cfg)
    args = [inp[k] for k in ("prompt", "valid", "logits0", "cache", "hist", "counts", "delta")]
    decode_chunk_lookahead(model, cfg, gen, SPEC, *args)                   # the capture
    torch.cuda.synchronize()
    graphs.reset_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode_chunk_lookahead(model, cfg, gen, SPEC, *args)
        with pytest.raises(RuntimeError):
            decode_chunk_lookahead_plain(model, cfg, gen, SPEC, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    st = graphs.stats()
    # one read after every window but a chunk's last possible one
    assert st["captures"] == 0 and st["windows"] > 0
    assert st["host_reads"] in (st["windows"] - 1, st["windows"])


def test_engine_lookahead_session_matches_plain_and_eager(cuda, monkeypatch):
    """A tiny bf16 session through the engine's fused lookahead (graphs),
    the same through the eager loop, and plain decoding: the same texts
    and history; the lookahead graph is captured once per cache."""
    from livecc_tpu_torch.engine import streaming

    cfg, model = tiny(cuda, torch.bfloat16)
    gen = GenerationParams(max_new_tokens=8, eos_token_id=3, pad_token_id=0,
                           repetition_penalty=1.05)
    graphs = graphs_for(model, cfg)
    sessions = []
    for mode in ("graphs", "eager", "plain"):
        if mode == "eager":
            monkeypatch.setattr(streaming, "decode_chunk_lookahead", decode_chunk_lookahead_plain)
        eng = LiveCCEngine(model, cfg, ByteTokenizer(), cache_len=512,
                           spec=None if mode == "plain" else SPEC)
        st = eng.new_stream(cache_len=512)
        graphs.reset_stats()
        texts = [eng.chunk_step(st, synth_frames(6, 28, 28, 0), 0.0, 3.0, "q", gen)]
        for i in range(5):
            texts.append(eng.chunk_step(st, synth_frames(2, 28, 28, i + 1), 3.0 + i, 4.0 + i,
                                        None, gen))
        sessions.append((texts, st.past_ids, st.length, graphs.stats()))
    (t_g, ids_g, len_g, stats), (t_e, ids_e, len_e, _), (t_p, ids_p, len_p, _) = sessions
    assert (t_g, ids_g, len_g) == (t_e, ids_e, len_e) == (t_p, ids_p, len_p)
    assert stats["captures"] == 1 and stats["windows"] > 0


WINDOW = kernel_timing.WINDOW_SQ


@pytest.mark.parametrize("quant", [False, True])
def test_k1_at_the_verify_window(cuda, quant):
    """K1 (bf16 cache, B = 1, offset 1500) and K1-int8 (the pool's B = 8 at
    the steady tick's depths) at Sq = 9, one query tile of 9 real rows: held
    to the plain version on the same inputs by ``kernel_check.close``, a
    limit the plain output without one 64-key tile fails; two launches
    bit-equal; K1-int8 also within ``FLIP_LIMIT`` of the fp32 plain
    version's roundings."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    L, hq, hk, d, smax = 3, 28, 4, 128, 8192
    if quant:
        offsets = list(kernel_timing.INT8_STEADY_OFFSETS)
        b = len(offsets)
        kv = []
        for _ in range(2):
            codes, scale = quantized_cache(gen, (L, b, hk, smax, d), cuda)
            kv += [codes, scale]
        k5, ks, v5, vs = kv
        scales = dict(k_scale=ks, v_scale=vs)
        layer_scales = dict(k_scale=ks[2], v_scale=vs[2])
    else:
        offsets, b = [1500], 1
        k5, v5 = (torch.randn((L, b, hk, smax, d), generator=gen, device=cuda).bfloat16()
                  for _ in range(2))
        scales, layer_scales = {}, {}
    limits = [o + WINDOW for o in offsets]
    q = torch.randn((b, WINDOW, hq, d), generator=gen, device=cuda).bfloat16().transpose(1, 2)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    lim = torch.tensor(limits, dtype=torch.int32, device=cuda)
    name = "flash_prefill_int8" if quant else "flash_prefill"
    before = build.launch_counts[name]
    out = flash_prefill(q, k5, v5, off, lim, layer_index=2, **scales)
    assert build.launch_counts[name] == before + 1
    ref = flash_prefill_plain(q, k5[2], v5[2], off, lim, *layer_scales.values())
    row = max(range(b), key=lambda i: limits[i])
    kt = min(limits[row], offsets[row] + 1) // 64 // 2       # the only query tile
    fault = kernel_check.drop_key_tile(ref, q, k5[2], v5[2], off, lim, 0, kt, head=hq - 1,
                                       row=row, **layer_scales)
    torch.cuda.synchronize()
    assert kernel_check.close(out, ref, torch.bfloat16) <= 1.0
    assert kernel_check.close(fault, ref, torch.bfloat16) > 1.0
    assert torch.equal(out, flash_prefill(q, k5, v5, off, lim, layer_index=2, **scales))
    if quant:
        ref32 = flash_prefill_plain(q.float(), k5[2], v5[2], off, lim, ks[2], vs[2])
        assert kernel_check.rounding_flips(out, ref32) <= kernel_check.FLIP_LIMIT


def quantized_cache(gen, shape, dev):
    """int8 K or V and its lane-major bf16 scales."""
    from livecc_tpu_torch.models.qwen2_vl.text import quantize_kv

    codes, scale = quantize_kv(torch.randn(shape, generator=gen, device=dev).bfloat16())
    return codes, scale.transpose(-1, -2).contiguous()

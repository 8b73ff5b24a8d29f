"""The 7B sessions that ``chip_smoke.py`` drives and ``profile_stream`` profiles.

Qwen2-VL-7B at full width and depth, bf16, random weights drawn on the card
from a seeded generator; uint8 frames of 308x560 from a numpy seed; 16 new
tokens per chunk, greedy, repetition penalty 1.05.

  * single stream: ``live_cc_once_for_evaluation`` over 14 frames (a 6-frame
    first chunk and four 2-frame chunks at 2 fps), bf16 KV cache of 8192;
  * serving pool: ``StreamServer`` with 8 slots, an int8 KV cache of 8192
    per slot, 8 streams that each send a 6-frame init chunk and then one
    2-frame chunk per steady tick (``run_pool``, shared with the tiny pool
    that chip_smoke runs on the CPU and on the GPU).

Either runs with speculative decoding given a ``SpecConfig``; ``SPEC`` is
the one measured (fused lookahead, 8 drafts, 3-grams, controller off), and
either with int8 matmul weights (``main_model(w8=True)``, K5; with the
pool's int8 KV cache, JAX's TPU serving configuration). As a script it runs
one of them on the card and prints each chunk's (or tick's) wall and text:

    python3 -m livecc_tpu_torch.tools.session [--pool] [--w8]
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.engine import GenerationParams, LiveCCEngine, SpecConfig
from livecc_tpu_torch.models.qwen2_vl.model import Qwen2VL, init_params
from livecc_tpu_torch.ops.quant import quantize_model
from livecc_tpu_torch.serve import StreamServer

SEED = 0
N_FRAMES, HEIGHT, WIDTH = 14, 308, 560   # the 720p serving budget's grid: 22 x 40 patches
QUERY = "What is happening?"
NEW_TOKENS, REPETITION_PENALTY = 16, 1.05
# the serving pool: 8 concurrent streams per replica, int8 KV
POOL_CAPACITY, POOL_STREAMS, POOL_CACHE_LEN, POOL_STEADY_TICKS = 8, 8, 8192, 3
INIT_FRAMES, STEADY_FRAMES = 6, 2
SPEC = SpecConfig(k_draft=8, max_ngram=3, fused=True, adaptive=False)


def synth_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """``n`` uint8 RGB frames of ``h`` x ``w`` from a numpy seed."""
    return np.random.RandomState(seed).randint(0, 256, size=(n, h, w, 3), dtype=np.uint8)


def main_model(device: str = "cuda", w8: bool = False) -> tuple[ModelConfig, Qwen2VL]:
    """The 7B at full depth, bf16, weights drawn on ``device`` from ``SEED``;
    with ``w8`` its matmul weights then quantized to int8 in place
    (``ops/quant.py:quantize_model``)."""
    cfg = ModelConfig.qwen2_vl_7b()
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = init_params(cfg, gen, device, torch.bfloat16)
    return cfg, quantize_model(model) if w8 else model


def model_bytes(model: Qwen2VL) -> int:
    """Bytes of a model's parameters and buffers (int8 codes and scales)."""
    return sum(t.numel() * t.element_size() for t in (*model.parameters(), *model.buffers()))


def main_frames() -> np.ndarray:
    return synth_frames(N_FRAMES, HEIGHT, WIDTH, seed=SEED)


def new_engine(cfg: ModelConfig, model: Qwen2VL, spec: SpecConfig | None = None) -> LiveCCEngine:
    return LiveCCEngine(model, cfg, ByteTokenizer.for_config(cfg), spec=spec)


def run_session(engine: LiveCCEngine, frames: np.ndarray, state=None) -> list:
    """One ``live_cc_once_for_evaluation`` call over ``frames``: ``[t0, t1, text]`` per chunk."""
    return engine.live_cc_once_for_evaluation(QUERY, frames, max_new_tokens=NEW_TOKENS,
                                              repetition_penalty=REPETITION_PENALTY, state=state)


def pool_server(cfg: ModelConfig, model: Qwen2VL, tokenizer=None, capacity: int = POOL_CAPACITY,
                cache_len: int = POOL_CACHE_LEN, spec: SpecConfig | None = None) -> StreamServer:
    """A serving pool on ``model`` with an int8 KV cache (lookahead decoding
    with a fused ``spec``)."""
    tokenizer = ByteTokenizer.for_config(cfg) if tokenizer is None else tokenizer
    engine = LiveCCEngine(model, cfg, tokenizer, cache_len=cache_len, cache_dtype=torch.int8,
                          spec=spec)
    gen = GenerationParams(max_new_tokens=NEW_TOKENS, eos_token_id=cfg.eos_token_id,
                           pad_token_id=cfg.pad_token_id, repetition_penalty=REPETITION_PENALTY)
    return StreamServer(engine, gen, capacity=capacity)


def run_pool(server: StreamServer, n_streams: int = POOL_STREAMS,
             steady_ticks: int = POOL_STEADY_TICKS, height: int = HEIGHT, width: int = WIDTH,
             seed: int = SEED, around_tick=None) -> tuple[dict[int, list], list[float]]:
    """``n_streams`` streams join at once: tick 0 runs every init chunk
    (solo, then adoption into the pool), each later tick one 2-frame chunk
    of every stream through the pool. Frames of stream i come from numpy
    seed ``seed + i``. ``around_tick(i)``, if given, returns a context
    manager entered around tick i and its timing (a profiler). Returns
    ({sid: [(span, text), ...]}, the synchronized wall seconds of every
    tick)."""
    n_frames = INIT_FRAMES + STEADY_FRAMES * steady_ticks
    sids = [server.add_stream((height, width), query=QUERY) for _ in range(n_streams)]
    clips = {sid: synth_frames(n_frames, height, width, seed + i) for i, sid in enumerate(sids)}
    fps = server.engine.fps
    outputs: dict[int, list] = {sid: [] for sid in sids}
    walls = []
    for tick in range(1 + steady_ticks):
        lo = 0 if tick == 0 else INIT_FRAMES + STEADY_FRAMES * (tick - 1)
        hi = INIT_FRAMES + STEADY_FRAMES * tick
        for sid in sids:
            server.submit_chunk(sid, clips[sid][lo:hi], lo / fps, hi / fps)
        sync = torch.cuda.synchronize if server.engine.device.type == "cuda" else (lambda: None)
        with contextlib.nullcontext() if around_tick is None else around_tick(tick):
            sync()
            t0 = time.perf_counter()
            server.tick()
            sync()
            walls.append(time.perf_counter() - t0)
        for sid in sids:
            outputs[sid].extend(server.drain(sid))
    return outputs, walls


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pool", action="store_true", help="the 8-stream int8-KV pool")
    ap.add_argument("--w8", action="store_true", help="int8 matmul weights (K5)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("session: needs a CUDA GPU")
    cfg, model = main_model(w8=args.w8)
    print(f"model {model_bytes(model) / 2**30:.2f} GiB on the card "
          f"({'int8' if args.w8 else 'bf16'} matmul weights)")
    if args.pool:
        out, walls = run_pool(pool_server(cfg, model))
        print("tick walls " + ", ".join(f"{w * 1e3:.1f}" for w in walls) + " ms")
        for sid, rows in out.items():
            print(f"stream {sid}: {[text for _, text in rows]!r}"[:200])
        return 0
    eng = new_engine(cfg, model)
    for (t0, t1, text), rec in zip(run_session(eng, main_frames()), eng.chunk_log):
        print(f"chunk {t0:4.1f}-{t1:4.1f}s wall {rec.seconds * 1e3:9.2f} ms  {text!r}"[:200])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

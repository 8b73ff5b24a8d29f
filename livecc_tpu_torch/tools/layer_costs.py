"""Per-layer serving and training costs of the 7B's width, measured on the card.

    python3 -m livecc_tpu_torch.tools.layer_costs

The port's counterpart of JAX's width probes (``tools/exp_7b_slice.py``,
``tools/exp_7b_train_slice.py``, differenced by ``bench.py:bench_7b_slice``
and ``bench_7b_train_slice``) and the producer of
``parallel/memory.py``'s measured rows. Each probe runs the port's own
path, so the card's kernels run:

  * ``width7b(depth)``: Qwen2-VL-7B's widths (hidden 3584, 28 q / 4 KV
    heads, head_dim 128, intermediate 18944, vocabulary 152064) with
    ``depth`` text layers and one ViT block, bf16 weights from a seed;
  * decode, a token at B = 1 and B = 8: a bf16 cache of 8192 seated at
    depth 4096, one ``decode_chunk`` (the step captured by
    ``engine/graphs.py``, K2), then the device time of one replay of that
    step (``step_replay_ms``);
  * prefill: 256 text tokens at B = 1 over the same cache (K1), the
    median of single calls between CUDA events; the script also profiles
    one call at each depth (``prefill_profile``: device busy time, idle
    share, device time by group);
  * the training step: one row of 8192 tokens (4096 supervised), remat,
    bf16, the fused chunked CE with bf16 logit rows, the ViT frozen,
    through ``train/step.py:make_train_step`` (K4 forward and backward),
    the median of synchronized steps after one warm-up.

Serving runs at depths (2, 4): per layer = (d4 - d2) / 2, remainder =
d2 - 2 * per layer (``costs_from_depths``). Training runs at (1, 3), with
the matmul-only FLOP model's rate against ``utils/calibrate.py``'s chain in
the same process (``train_costs_from_depths``). The script prints the card
and one JSON line per probe. Needs a CUDA GPU.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from livecc_tpu_torch.core.config import ModelConfig, TextConfig
from livecc_tpu_torch.parallel.memory import (
    MeasuredLayerCosts, MeasuredTrainCosts, head_read_ms)

SEED = 0
CACHE_LEN, KV_DEPTH, PREFILL_LEN = 8192, 4096, 256
SERVING_DEPTHS, TRAIN_DEPTHS = (2, 4), (1, 3)
SEQ, SUP = 8192, 4096
DECODE_TOKENS, PREFILL_REPS, TRAIN_REPS = 16, 7, 3


def width7b(depth: int) -> ModelConfig:
    """The 7B's widths with ``depth`` text layers and one ViT block."""
    full = ModelConfig.qwen2_vl_7b()
    return dataclasses.replace(
        full,
        vision=dataclasses.replace(full.vision, depth=1),
        text=dataclasses.replace(full.text, num_hidden_layers=depth),
        name=f"qwen2-vl-7b-w-d{depth}",
    )


def new_model(cfg: ModelConfig, device="cuda"):
    """bf16 weights drawn on ``device`` from ``SEED``."""
    from livecc_tpu_torch.models.qwen2_vl.model import init_params

    gen = torch.Generator(device=device).manual_seed(SEED)
    return init_params(cfg, gen, device, torch.bfloat16)


def step_replay_ms(model, cache, state_type) -> float:
    """Device time of one replay of the captured step of ``model`` over
    ``cache`` whose state is a ``state_type``, after its chunk ended:
    ``kernel_timing.replay_ms`` over 14 replays from step index 0, since a
    decode step writes its token column at the index, which ends at
    max_new_tokens (16)."""
    from livecc_tpu_torch.engine.generation import DecodeState
    from livecc_tpu_torch.engine.graphs import graphs_for
    from livecc_tpu_torch.tools.kernel_timing import replay_ms

    found = [g for g in graphs_for(model, model.cfg).graphs.values()
             if g.owner() is cache.k and isinstance(g.state, state_type) and g.graph is not None]
    if len(found) != 1:
        raise AssertionError(f"expected one captured {state_type.__name__} step on the cache, "
                             f"found {len(found)}")
    if isinstance(found[0].state, DecodeState):
        found[0].state.step.zero_()
    return replay_ms(found[0].graph, replays=12, warmup=2)


def seated_cache(cfg: ModelConfig, batch: int, device):
    """A bf16 cache of ``CACHE_LEN`` with every row at depth ``KV_DEPTH``."""
    from livecc_tpu_torch.models.qwen2_vl.text import KVCache

    cache = KVCache.zeros(cfg.text, batch, CACHE_LEN, torch.bfloat16, device)
    cache.offset = torch.full((batch,), KV_DEPTH, dtype=torch.int32, device=device)
    return cache


def decode_ms(model, cfg: ModelConfig, batch: int, device="cuda") -> float:
    """Device milliseconds of one decode step at ``batch`` rows: one
    ``decode_chunk`` of ``DECODE_TOKENS`` (an eos that never fires, so
    every step runs), then one replay of its captured step."""
    from livecc_tpu_torch.engine.generation import DecodeState, GenerationParams, decode_chunk

    cache = seated_cache(cfg, batch, device)
    v = cfg.text.vocab_size
    gen = GenerationParams(max_new_tokens=DECODE_TOKENS, eos_token_id=-1,
                           pad_token_id=cfg.pad_token_id)
    decode_chunk(model, cfg, gen, torch.zeros((batch, v), dtype=torch.float32, device=device),
                 cache, torch.zeros((batch, v), dtype=torch.int32, device=device),
                 torch.zeros((batch, 1), dtype=torch.int32, device=device))
    return step_replay_ms(model, cache, DecodeState)


def prefill_call(model, cfg: ModelConfig, device="cuda"):
    """A call of one ``PREFILL_LEN``-token prefill at B = 1 over a seated
    cache, which it resets to ``KV_DEPTH`` first."""
    from livecc_tpu_torch.engine.generation import prefill

    rng = np.random.RandomState(SEED)
    hi = min(10000, cfg.text.vocab_size)
    ids = torch.from_numpy(rng.randint(8, hi, size=(1, PREFILL_LEN)).astype(np.int32))
    pos = np.broadcast_to(KV_DEPTH + np.arange(PREFILL_LEN)[None, None], (3, 1, PREFILL_LEN))
    ids, pos = ids.to(device), torch.from_numpy(pos.astype(np.int32)).to(device)
    cache = seated_cache(cfg, 1, device)
    depth = cache.offset.clone()

    def call():
        cache.offset = depth
        prefill(model, cfg, ids, pos, PREFILL_LEN, cache)

    return call


def prefill_profile(depth: int, device="cuda") -> dict:
    """One ``prefill_call`` of ``width7b(depth)`` under ``torch.profiler``
    (CUDA activity) after two warm-up calls: {"wall_ms", "busy_ms": the
    union of its kernels' intervals, "idle", "device_ops": the kernels and
    copies it ran, "groups_ms": device time by ``profile_stream``'s
    groups}."""
    from torch.profiler import ProfilerActivity, profile

    from livecc_tpu_torch.tools.profile_stream import busy_seconds, device_groups

    cfg = width7b(depth)
    model = new_model(cfg, device)
    call = prefill_call(model, cfg, device)
    with torch.no_grad():
        call()
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    busy = busy_seconds(prof)
    out = {"wall_ms": wall * 1e3, "busy_ms": busy * 1e3, "idle": 1 - busy / wall,
           "device_ops": sum(e.device_type == torch.autograd.DeviceType.CUDA
                             for e in prof.events()),
           "groups_ms": {g: t * 1e3 for g, t in device_groups(prof).items()}}
    del model, call, prof
    torch.cuda.empty_cache()
    return out


def serving_walls(depth: int, device="cuda") -> dict:
    """{"d1", "d8": decode step ms at B = 1 / 8, "p256": the median ms of
    single ``prefill_call``s between CUDA events, host work included
    (``kernel_timing.cuda_ms``)} of ``width7b(depth)``."""
    from livecc_tpu_torch.tools.kernel_timing import cuda_ms

    cfg = width7b(depth)
    model = new_model(cfg, device)
    with torch.no_grad():
        out = {"d1": decode_ms(model, cfg, 1, device), "d8": decode_ms(model, cfg, 8, device),
               "p256": cuda_ms(prefill_call(model, cfg, device), iters=PREFILL_REPS)}
    del model
    torch.cuda.empty_cache()
    return out


def train_batch(cfg: ModelConfig, device="cuda"):
    """One window of one row of ``SEQ`` seeded ids, ``SUP`` random positions
    supervised, positions 0..S-1, every key valid."""
    from livecc_tpu_torch.train.step import Batch

    rng = np.random.RandomState(SEED)
    hi = min(10000, cfg.text.vocab_size)
    ids = rng.randint(8, hi, size=(1, 1, SEQ))
    labels = np.full((1, 1, SEQ), -100)
    sup = rng.choice(SEQ - 1, size=SUP, replace=False)
    labels[0, 0, sup] = rng.randint(8, hi, size=SUP)
    pos = np.broadcast_to(np.arange(SEQ), (1, 3, 1, SEQ))
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Batch(input_ids=as_dev(ids), labels=as_dev(labels), position_ids=as_dev(pos),
                 attention_mask=torch.ones((1, 1, SEQ), dtype=torch.bool, device=device))


def train_walls(depth: int, device="cuda", reps: int = TRAIN_REPS) -> dict:
    """The training step of ``width7b(depth)`` (JAX's probe's recipe: AdamW
    with b2 0.95 and a bf16 first moment): {"median_ms", "walls_ms",
    "loss", "peak_bytes": the steps' peak above what was allocated before
    the model, "state_bytes": the weights, AdamW's moments and the step's
    fp32 gradient accumulator}."""
    from livecc_tpu_torch.train.step import (
        TrainConfig, make_optimizer, make_train_step, split_frozen)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cfg = width7b(depth)
    model = new_model(cfg, device)
    tcfg = TrainConfig(learning_rate=2e-5, adam_b2=0.95, adam_mu_dtype=torch.bfloat16,
                       remat=True, total_steps=100, freeze_modules=("visual",))
    opt = make_optimizer(tcfg)
    trainable, _ = split_frozen(model, tcfg.freeze_modules)
    state = opt.init(trainable)
    step = make_train_step(cfg, tcfg, opt)
    batch = train_batch(cfg, device)
    model, state, m = step(model, state, batch)              # warm-up
    float(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, state, m = step(model, state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    state_bytes = (nbytes(model.parameters()) + nbytes(state["mu"].values())
                   + nbytes(state["nu"].values()) + 4 * sum(p.numel() for p in trainable.values()))
    out = {"median_ms": statistics.median(walls), "walls_ms": walls, "loss": loss,
           "peak_bytes": torch.cuda.max_memory_allocated() - base, "state_bytes": state_bytes}
    del model, state, trainable, step, batch
    torch.cuda.empty_cache()
    return out


def flop_model_per_layer(cfg_text: TextConfig, seq: int) -> float:
    """JAX's matmul-only FLOP model of one layer's train step
    (``tools/exp_7b_train_slice.py:142``): 3x the forward's
    2 * S * P_layer + 4 * S^2 * hidden (remat's recompute excluded)."""
    h = cfg_text.hidden_size
    kvh = cfg_text.num_key_value_heads * cfg_text.head_dim
    p_layer = h * (h + 2 * kvh + h) + 3 * h * cfg_text.intermediate_size
    fwd = 2 * seq * p_layer + 4 * seq * seq * h
    return 3.0 * fwd


def costs_from_depths(meas: dict, provenance: str,
                      depths: tuple[int, int] = SERVING_DEPTHS) -> MeasuredLayerCosts:
    """``bench.py:bench_7b_slice``'s differencing of serving walls in ms
    (``meas[depth]`` = {"d1", "d8", "p256"}): per layer = (hi - lo) /
    (hi - lo depths); the B = 1 decode's remainder lo - lo_depth * per layer
    splits into the head's read (``head_read_ms``, a bound) and the rest."""
    lo, hi = depths
    per = {k: (meas[hi][k] - meas[lo][k]) / (hi - lo) for k in ("d1", "d8", "p256")}
    remainder = meas[lo]["d1"] - lo * per["d1"]
    head = head_read_ms(ModelConfig.qwen2_vl_7b())
    return MeasuredLayerCosts(
        per_layer_decode_b1_ms=per["d1"], per_layer_decode_b8_ms=per["d8"],
        per_layer_prefill256_ms=per["p256"], lm_head_ms=head, overhead_ms=remainder - head,
        provenance=provenance)


def train_costs_from_depths(meas: dict, cal_tflops: float, provenance: str,
                            depths: tuple[int, int] = TRAIN_DEPTHS,
                            seq: int = SEQ) -> MeasuredTrainCosts:
    """``bench.py:bench_7b_train_slice``'s differencing of step walls in ms
    (``meas[depth]``): per layer, the remainder at the lower depth, and the
    FLOP model's rate against the calibration ``cal_tflops``."""
    lo, hi = depths
    per_layer = (meas[hi] - meas[lo]) / (hi - lo)
    tflops = flop_model_per_layer(ModelConfig.qwen2_vl_7b().text, seq) / (per_layer / 1e3) / 1e12
    return MeasuredTrainCosts(
        per_layer_step_ms=per_layer, remainder_ms=meas[lo] - lo * per_layer, seq=seq,
        measured_tflops=tflops, vs_calibrated=tflops / cal_tflops, provenance=provenance)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def measure(provenance: str, device="cuda", emit=print, train_depths=TRAIN_DEPTHS) -> dict:
    """Every probe, each printed as a JSON line through ``emit``: the
    calibration, serving at ``SERVING_DEPTHS``, training at
    ``train_depths`` (its first two difference), then both cost rows.
    Returns {"cal", "serving", "train": {depth: train_walls}, "costs",
    "train_costs"}."""
    from livecc_tpu_torch.utils.calibrate import calibrate_matmul

    cal = calibrate_matmul(device)
    emit(json.dumps({"probe": "cal", **cal}))
    serving = {}
    for depth in SERVING_DEPTHS:
        serving[depth] = serving_walls(depth, device)
        emit(json.dumps({"probe": "serving", "depth": depth, **serving[depth]}))
    train = {}
    for depth in train_depths:
        train[depth] = train_walls(depth, device)
        emit(json.dumps({"probe": "train", "depth": depth, **train[depth]}))
    costs = costs_from_depths(serving, provenance)
    train_costs = train_costs_from_depths({d: train[d]["median_ms"] for d in train_depths[:2]},
                                          cal["achieved_tflops"], provenance,
                                          depths=tuple(train_depths[:2]))
    emit(json.dumps({"probe": "serving_costs", **dataclasses.asdict(costs)}))
    emit(json.dumps({"probe": "train_costs", **dataclasses.asdict(train_costs)}))
    return {"cal": cal, "serving": serving, "train": train, "costs": costs,
            "train_costs": train_costs}


def main() -> int:
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.utils.device import device_for

    device_for("cuda", "layer_costs")             # raises without a card
    card = card_line()
    print(card)
    build.build_library()
    measure(f"layer_costs on {card}, {time.strftime('%Y-%m-%d')}")
    for depth in SERVING_DEPTHS:
        print(json.dumps({"probe": "prefill_profile", "depth": depth, **prefill_profile(depth)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

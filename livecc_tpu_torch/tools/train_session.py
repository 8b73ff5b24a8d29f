"""The training session that ``chip_smoke.py`` drives, and its profile.

    python3 -m livecc_tpu_torch.tools.train_session            # 3 steps, walls and rates
    python3 -m livecc_tpu_torch.tools.train_session --profile  # + one step under the profiler

Run by path with another checkout first on ``PYTHONPATH``, it drives that
checkout's ``Trainer`` and train step with this session, so two checkouts'
step walls and step peaks compare in one call:

    PYTHONPATH=<checkout> python3 livecc_tpu_torch/tools/train_session.py

The port's counterpart of ``bench.py:bench_train`` and
``tools/train_e2e_tpu.py``: processed samples are built from seeded
synthetic frames through the port's own ``device_patchify``, chat template,
tokenizer and ``get_rope_index`` (labels on the assistant span only), then
the single-GPU ``Trainer`` runs a few steps on them.

The configuration: Qwen2-VL-7B at full width (hidden 3584, 28 q / 4 KV
heads, head_dim 128, intermediate 18944, vocabulary 152064, the 32-block
ViT frozen) with the LLM cut to ``DEPTH`` = 4 layers (the JAX e2e tool's
depth); bf16 weights drawn on the card from a seeded generator;
``TrainConfig(learning_rate=2e-5, total_steps=3, remat=True)``,
``TrainerConfig(accum_steps=2, pack_seq=8192)``. Each sample is a clip of
24 frames of 224x476 (grid (12, 16, 34), 1,632 video tokens) with
400-2,400 text tokens, so an 8192-token row packs 2-4 samples.

Needs a CUDA GPU; ``tiny_samples`` also serves the CPU tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import numpy as np
import torch

from livecc_tpu_torch.core.config import ModelConfig, tiny_config
from livecc_tpu_torch.data import chat
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.models.qwen2_vl.model import Qwen2VL, get_rope_index, init_params
from livecc_tpu_torch.train.data import collate_packed_rows, pack_samples
from livecc_tpu_torch.train.step import (
    TrainConfig, loss_fn, make_optimizer, make_train_step, split_frozen)
from livecc_tpu_torch.train.trainer import Trainer, TrainerConfig
from livecc_tpu_torch.utils.flops import train_step_flops, vit_forward_flops
from livecc_tpu_torch.vision_io.patchify import device_patchify, grid_for_frames

SEED = 0
DEPTH = 4
N_FRAMES, HEIGHT, WIDTH = 24, 224, 476          # grid (12, 16, 34): 1,632 video tokens
TEXT_TOKENS = (400, 2400)
N_SAMPLES = 8
PACK_SEQ, ACCUM, STEPS, LEARNING_RATE = 8192, 2, 3, 2e-5
QUERY = "Please commentate on the video."


def train_model_config(depth: int = DEPTH) -> ModelConfig:
    """Qwen2-VL-7B at full width, the LLM cut to ``depth`` layers."""
    full = ModelConfig.qwen2_vl_7b()
    return dataclasses.replace(full, text=dataclasses.replace(full.text, num_hidden_layers=depth),
                               name=f"{full.name}-d{depth}")


def make_sample(cfg: ModelConfig, tokenizer, frames: np.ndarray, n_text: int,
                rng: np.random.RandomState, device="cuda") -> dict:
    """One processed sample: a user turn with the clip and a query, and an
    assistant commentary of about ``n_text`` tokens, supervised alone."""
    patches = device_patchify(torch.from_numpy(frames).to(device)).cpu().numpy()
    grid = grid_for_frames(*frames.shape[:3], cfg.vision)
    user = {"role": "user", "content": [{"type": "video", "video": None},
                                        {"type": "text", "text": QUERY}]}
    prompt = chat.render_chat([user], add_generation_prompt=True)
    words, length = [], 0
    while length < n_text:
        words.append(f"word{rng.randint(1000)}")
        length += len(words[-1]) + 1
    reply = {"role": "assistant", "content": " ".join(words)}
    full = chat.render_chat([user, reply])
    ids_prompt = tokenizer.encode(chat.expand_vision_placeholders(prompt, video_grid_thw=[grid]))
    ids = tokenizer.encode(chat.expand_vision_placeholders(full, video_grid_thw=[grid]))
    assert ids[:len(ids_prompt)] == ids_prompt
    ids = np.asarray([ids], np.int32)
    labels = ids.copy()
    labels[0, :len(ids_prompt)] = -100
    pos, _ = get_rope_index(cfg, ids, video_grid_thw=np.asarray([grid]))
    return {"input_ids": ids, "labels": labels, "position_ids": pos,
            "pixel_patches": patches, "video_grid_thw": np.asarray([grid]),
            "image_patches": None, "image_grid_thw": None}


def synth_samples(cfg: ModelConfig, n: int, n_frames: int, height: int, width: int,
                  text_tokens: tuple[int, int], seed: int = SEED, device="cuda") -> list[dict]:
    """``n`` samples from numpy seed ``seed``: uint8 frames and text lengths."""
    rng = np.random.RandomState(seed)
    tokenizer = ByteTokenizer.for_config(cfg)
    out = []
    for _ in range(n):
        frames = rng.randint(0, 256, size=(n_frames, height, width, 3), dtype=np.uint8)
        out.append(make_sample(cfg, tokenizer, frames, rng.randint(*text_tokens), rng, device))
    return out


def tiny_samples(cfg: ModelConfig, n: int = 4, seed: int = SEED, device="cpu") -> list[dict]:
    """Small samples for the tiny config: 4 frames of 28x56, 20-60 text tokens."""
    return synth_samples(cfg, n, 4, 28, 56, (20, 61), seed, device)


def tiny_train_losses(device, steps: int = 3) -> list[float]:
    """Losses of ``steps`` fp32 training steps of the tiny config on
    ``device``: weights drawn on the CPU from ``SEED``, 4 samples packed in
    rows of 512, accumulation 2, fp32 logit rows. The CPU runs the plain
    versions, CUDA the kernels; the two must agree."""
    cfg = tiny_config()
    model = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu", torch.float32).to(device)
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=10, ce_chunk_size=32, ce_logits="f32")
    opt = make_optimizer(tcfg)
    state = opt.init(split_frozen(model, tcfg.freeze_modules)[0])
    fn = make_train_step(cfg, tcfg, opt)
    packed, _ = pack_samples(tiny_samples(cfg, n=4, seed=SEED), 512)
    batch = collate_packed_rows(packed, cfg, accum=2, device=device)
    losses = []
    for _ in range(steps):
        model, state, metrics = fn(model, state, batch)
        losses.append(float(metrics["loss"]))
    return losses


def tiny_vit_grads(device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    """The gradients of one training step's loss for every ViT parameter
    of the tiny config with nothing frozen, as fp32 CPU tensors: weights
    drawn on the CPU from ``SEED`` in fp32, then cast to ``dtype`` on
    ``device``; 4 samples packed in rows of 512 (two micro-batches, their
    summed losses taken back at once), fp32 logit rows. On CUDA the ViT's
    attention runs K3 forward and its autograd ``Function`` backward; on
    the CPU the plain version's autograd."""
    cfg = tiny_config()
    model = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu", torch.float32)
    model = model.to(device=device, dtype=dtype)
    tcfg = TrainConfig(freeze_modules=(), ce_chunk_size=32, ce_logits="f32")
    split_frozen(model, tcfg.freeze_modules)
    packed, _ = pack_samples(tiny_samples(cfg, n=4, seed=SEED), 512)
    batch = collate_packed_rows(packed, cfg, accum=2, device=device)
    sum(loss_fn(model, cfg, tcfg, batch.micro(i))[0] for i in range(batch.accum)).backward()
    return {n: p.grad.float().cpu() for n, p in model.visual.named_parameters()}


def train_model(cfg: ModelConfig, device="cuda") -> Qwen2VL:
    """bf16 weights drawn on ``device`` from ``SEED``."""
    return init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device,
                       torch.bfloat16)


def new_trainer(cfg: ModelConfig, model: Qwen2VL, samples: list[dict], output_dir: str,
                steps: int = STEPS) -> Trainer:
    tcfg = TrainConfig(learning_rate=LEARNING_RATE, total_steps=steps, remat=True,
                       freeze_modules=("visual",))
    run = TrainerConfig(output_dir=output_dir, total_steps=steps, accum_steps=ACCUM,
                        pack_seq=PACK_SEQ, save_steps=None, log_steps=1, resume=False,
                        loader_workers=1)
    return Trainer(model, cfg, tcfg, run, samples)


def window_flops(cfg: ModelConfig, batch) -> tuple[int, int]:
    """(model FLOPs, real tokens) of one window: the LLM and the CE head
    over each segment's real tokens (a segment attends only itself, so its
    attention is causal over its own length), and the frozen ViT forward
    over each micro-batch's real patches."""
    flops = tokens = 0
    seg = batch.attention_mask.cpu().to(torch.int64)     # bool: one segment of id 1
    for a in range(batch.accum):
        for row in seg[a]:
            ids = row[row > 0]
            flops += sum(train_step_flops(cfg, n, n) for n in torch.bincount(ids).tolist() if n)
            tokens += ids.numel()
        if batch.vision_seg_ids is not None:
            patches = int((batch.vision_seg_ids[a] >= 0).sum())
            flops += vit_forward_flops(cfg.vision, patches, batch.vision_group)
    return flops, tokens


def run_steps(trainer: Trainer) -> list[dict]:
    """Run the trainer to its end; one record per step: synchronized wall,
    loss, supervised and real tokens, tokens/s, model TFLOP/s, the step's
    peak device memory (the Trainer resets the peak after each logged step,
    and this trainer logs every step) and the (NG, g) of the step's K3 calls
    (None without a uniform vision grid)."""
    records = []
    torch.cuda.synchronize()
    last = [time.perf_counter()]

    def on_step(step, batch, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        flops, tokens = window_flops(trainer.cfg, batch)
        wall = now - last[0]
        records.append({"step": step, "wall_s": wall, "loss": float(metrics["loss"]),
                        "supervised": int(metrics["tokens"]), "tokens": tokens,
                        "tokens_per_s": tokens / wall, "model_tflops": flops / wall / 1e12,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "vit_shape": None if batch.vision_group is None else (
                            batch.vision_patches.shape[-2] // batch.vision_group,
                            batch.vision_group)})
        last[0] = time.perf_counter()

    trainer.train(on_step=on_step)
    return records


def profile_step(trainer: Trainer) -> None:
    """One more step under ``torch.profiler``: device busy time, idle share
    and device time by group."""
    from torch.profiler import ProfilerActivity, profile

    from livecc_tpu_torch.tools.profile_stream import report

    trainer.run.total_steps = trainer.step + 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"profiled step {trainer.step}: wall {wall:.3f} s (batch load included)")
    report(prof, wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the steps, profile one more step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_session: needs a CUDA GPU")
    cfg = train_model_config()
    samples = synth_samples(cfg, N_SAMPLES, N_FRAMES, HEIGHT, WIDTH, TEXT_TOKENS)
    model = train_model(cfg)
    with tempfile.TemporaryDirectory() as out:
        trainer = new_trainer(cfg, model, samples, out)
        torch.cuda.reset_peak_memory_stats()
        for rec in run_steps(trainer):
            print({k: round(v, 4) if isinstance(v, float) else v for k, v in rec.items()})
        print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if args.profile:
            profile_step(trainer)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

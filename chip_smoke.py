#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``livecc_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

  1. device    — CUDA must be available (no CPU fallback); prints versions
                 and the card's name and power limit from nvidia-smi.
  2. build     — builds the kernels from ``livecc_tpu_torch/csrc`` (nvcc,
                 sm_90a, one process per source, in parallel).
  3. kernels   — each kernel (K1 flash_prefill, K2 flash_decode, their int8
                 variants, K3 vit_group_attention, K4 train_attention_fwd and
                 train_attention_bwd, K5 w8a16_gemm) against its plain PyTorch
                 version on the card at the paths' shapes. bf16 K1, K1-int8, K2 and
                 K3 are held to the plain version in their own dtype by
                 ``kernel_check.close``, a limit that must also fail a
                 planted fault: a dropped split for K2
                 (``kernel_check.drop_split``), one dropped 64-key tile of
                 one 64-query tile for K1, K1-int8 (the deepest row's, with
                 the scales) and K3 (``drop_key_tile``); their timed cases
                 also check that two launches are bit-equal. fp32 cases are
                 held to <= 1e-4 max abs. K3 also runs
                 mixed segment sizes through its bounds form, and K2 a query
                 group of G * D = 4096 (two launches). K1 and K1-int8 are
                 also held, faulted and timed at a verify window of
                 speculative decoding (Sq = ``kernel_timing.WINDOW_SQ`` = 9;
                 K1 at offset 1500, K1-int8 at ``INT8_STEADY_OFFSETS``; their
                 queries come from a generator of their own, so every other
                 case keeps its inputs). Times: kernel, plain
                 version and the one PyTorch call that computes the same
                 function (library; none for the int8 kernels), each the
                 median of single calls between CUDA events, host work
                 included (``kernel_timing.cuda_ms``), beside the least time
                 the card could take for the same work (bound); K1, K1-int8,
                 K2 and K3 also in device time (``kernel_timing.graph_ms``,
                 CUDA graph replay). K3 and K1 are timed at
                 ``kernel_timing.VIT_SHAPES`` and ``PREFILL_SHAPES`` (the
                 first timed shape gives the JSON line's numbers). The int8
                 kernels run on the pool's cache
                 [28, 8, 4, 8192, 128] int8 with bf16 scales, K1-int8 at the
                 timed pool tick (``kernel_timing.INT8_POOL_OFFSETS``, the
                 JSON line's numbers), a steady tick
                 (``INT8_STEADY_OFFSETS``) and the solo init chunk
                 (``INT8_SOLO``, batch row 0), each also held to the fp32
                 plain version: under ``kernel_check.FLIP_LIMIT`` of its
                 outputs may round the other way, a limit that p * v_scale
                 fed as one bf16 part (``kernel_check.one_part_pv``) must
                 fail; K4 at the
                 training shape (Hq 28, Hk 4, D 128) on packed rows of 4096
                 and 1000 (checked) and 8192 (checked and timed, also in
                 device time), each output also held elementwise to the
                 plain version in its own dtype (bf16 gradients: to the
                 fp32 plain version within what the bf16 plain version's
                 rounding allows, ``kernel_check.grad_close``) by a limit
                 that must fail one dropped tile pair
                 (``kernel_check.dropped_tile``), and two bf16 launches
                 bit-equal (``phase_k4``). K5 (``phase_k5``) at
                 ``kernel_timing.W8_SHAPES`` (decode and verify-window rows
                 on gate_proj, down_proj, k_proj and the fp32 lm_head,
                 prefill rows on gate_proj and down_proj, the ViT's fc1),
                 held by ``kernel_check.close`` in the output's dtype, a
                 limit that a dropped K split (small form, M <= 16) or one
                 dropped 64-wide K stage of one output tile of
                 ``quant.large_plan``'s tiling (large form) must fail; two
                 launches bit-equal; kernel, plain version and torch.mm on
                 the bf16 weight timed both ways beside the bound.
  4. tiny      — tiny config, fp32, seeded random weights: the engine on the
                 CPU (plain versions, the eager decode loop) and on the GPU
                 (kernels, the decode step replayed as a CUDA graph) give
                 identical greedy text over 3 chunks; the tiny ViT on two clips of
                 different grids runs K3's bounds form (fp32 and bf16) and
                 agrees with the CPU.
  5. tiny_pool — the same model in a StreamServer with an int8 cache,
                 capacity 3 and 2 streams over 4 ticks, on the CPU and on the
                 GPU: identical text for every stream.
     tiny_w8   — the tiny engine of ``tiny`` with int8 weights
                 (``quantize_weights=True``): CPU (plain) and GPU (K5's fp32
                 form) give identical text; K5 launched.
  6. main      — the single-stream session of ``livecc_tpu_torch/tools/
                 session.py``: Qwen2-VL-7B at full width and depth, bf16,
                 random weights drawn on the card from a seeded generator;
                 live_cc_once_for_evaluation over 14 frames of 308x560 (a
                 6-frame chunk and four 2-frame chunks), 16 new tokens per
                 chunk, greedy, repetition penalty 1.05.
  7. pool      — the same 7B model object in the serving pool of session.py:
                 StreamServer with 8 slots, an int8 KV cache of 8192, 8
                 streams of 308x560 frames (warmup, a 6-frame init chunk,
                 then 3 steady ticks of 2-frame chunks). Every stream must
                 get text for all 4 chunks.
                 main and pool decode through the captured CUDA graphs
                 (``engine/graphs.py``); each session also runs on the same
                 model from the same starting state through the eager plain
                 loop (``decode_chunk_plain``, called by name), and the two
                 must emit the same tokens in every decode and launch every
                 kernel as often (replays counted). Each prints walls,
                 captures (count and seconds), replays and host reads, and
                 the graph session (pool: one steady tick of a fresh run)
                 once more under the profiler, the device's busy time; and
                 one replay of the decode step at the session's last depth,
                 in device time.
  8. main_spec — main's session with speculative decoding
                 (``session.SPEC``: fused lookahead, 8 drafts, 3-grams, the
                 controller off) through the captured lookahead step and
                 through the eager lookahead loop
                 (``decode_chunk_lookahead_plain``, called by name): both
                 must emit main's tokens in every decode (greedy decoding is
                 lossless) and launch every kernel as often, and the graphs
                 read one stop flag per window. Prints walls, windows and
                 tokens per chunk, captures, and one lookahead-step replay
                 against main's decode-step replay at the same depth (the
                 window premium at B = 1). Then the worst case: the
                 host-drafted loop over the first two chunks with drafts of
                 an id the session never emits (one window per token).
  9. pool_spec — pool's session with lookahead decoding, the same checks
                 against pool's tokens; the window premium at B = 8.
     main_w8   — main's session on the same 7B (same seed) with int8
                 weights (``session.main_model(w8=True)``: every quantized
                 site a QuantLinear / QuantEmbedding; memory and the
                 quantization's peak printed) and a bf16 KV cache, through
                 the decode graphs and the eager plain loop (identical
                 tokens, K5 launched); wall, busy and the B = 1 step replay
                 beside main's; then one lookahead session (K5 at M = 9 in
                 the window graph) held as main_spec is.
     pool_w8   — pool's 8 streams on that model: int8 weights with the
                 int8 KV cache, JAX's TPU serving configuration; graphs
                 against the eager plain loop, ticks, busy and the B = 8
                 step replay beside pool's.
     eval      — the benchmark harnesses (``livecc_tpu_torch/eval``) on
                 main's 7B (bf16, full depth): two VideoMME items at the 720p
                 budget (64 frames of a 720x1280 source at 2 fps, served by
                 ``FramesVideo`` at the budget's 560x1008, which the
                 predictor must ask for: 32 ViT groups of g = 2880, 23k
                 tokens in the 32768 bucket) through ``videomme.run`` at
                 batch 1 and 2 (report written and merged; letters equal
                 but at a near-tie; K3 and K4's forward launched, no
                 backward); each item's host and forward walls, one item
                 profiled (busy, idle share, device time by group, model
                 FLOP rate), peak device memory. Then K3 and K4's forward
                 on that item's last ViT block's and LLM layer's q, k, v
                 against ``kernel_check``'s blocked plain versions by
                 ``close``, which a dropped key tile (the heaviest of a
                 query tile) must fail; kernel, blocked plain and SDPA
                 times beside the bound. The reduced item (8 frames of
                 560x1008, batch 2, the 4096 bucket): letter logits with the
                 kernels within ``close``'s bf16 limit of the plain path's
                 (K3 and K4's plain versions swapped in). A LiveSports-3K
                 CC event (10 s at 2 fps of 308x560) through
                 ``livesports3kcc.generate``: rows equal a direct
                 ``live_cc_once_for_evaluation``; wall and FLOP rate
                 (``serving_chunk_flops``); one caption. Where Pillow is
                 installed, ``eval.cli.main mvbench`` on the tiny model over
                 a frame directory (else it says so).
 10. checkpoint_live — the front door on main's 7B: written as an HF
                 checkpoint (bf16 safetensors shards of ~5 GB with an index,
                 config.json from tests/fixtures/qwen2_vl_7b_config.json)
                 under build/ after a check of free disk, loaded back by
                 ``load_checkpoint`` onto the card (every parameter
                 bit-equal; load seconds, peak device memory and peak host
                 RSS printed), then a 10 s clip of 308x560 frames at 10 fps
                 through the CLI's engine built on the checkpoint:
                 ``demo.cli.main`` on the clip encoded by the port's decoder
                 where pkg-config finds the FFmpeg development libraries,
                 else ``LiveCC`` over the frames through a ``video_loader``
                 (it says which). Spans contiguous from the 3 s init chunk,
                 text in every chunk, and greedy tokens identical to the same
                 frames through ``session.new_engine`` on the source model.
                 Then the same through the CLI's ``--quantize-weights``
                 (loaded, quantized, served through K5): text in every chunk.
 11. tiny_train — tiny config, fp32: 3 training steps (packed rows, accum 2)
                 on the CPU (plain versions) and on the GPU (kernels, fused
                 CE with fp32 logit rows); the losses agree to 1e-4. Then
                 one step's gradients with the ViT unfrozen, fp32 and bf16,
                 on the GPU against the CPU plain path's autograd
                 (``kernel_check.grad_close``), which a zeroed K3 backward
                 (``kernel_check.zeroed_k3_backward``) must fail.
 12. train     — ``livecc_tpu_torch/tools/train_session.py``: Qwen2-VL-7B at
                 full width with the LLM cut to 4 layers and the 32-block ViT
                 frozen, bf16, 3 Trainer steps of 2 packed 8192-token rows;
                 checks finite losses, trainable params moved after step 2
                 (all but the bf16 norm scales, whose update is below half a
                 bf16 step at 1.0), the ViT bit-unchanged, K4 fwd/bwd and
                 K3 launched, and that K3 ran at the training shape the
                 kernels phase timed.

Launch counts are reset just before each of main, pool, main_spec (and
its worst case), pool_spec, main_w8 (and its lookahead session), pool_w8,
eval's two VideoMME runs and its CC event, checkpoint_live's two CLI runs
and train and read just after; every kernel of
that path must have launched. Every phase always
runs. After all of them passed it prints one JSON line ``{"kernels": [...]}``
and, as its last line, ``{"ok": true, "device": {...}}``. It imports nothing
of JAX.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

KERNELS = {
    # name: (source in the repo, TPU kernel it replaces)
    "vit_group_attention": ("livecc_tpu_torch/csrc/vit_attention.cu",
                            "livecc_tpu/ops/pallas/vit_attention.py:127"),
    "flash_prefill": ("livecc_tpu_torch/csrc/flash_prefill.cu",
                      "livecc_tpu/ops/pallas/attention.py:114"),
    "flash_decode": ("livecc_tpu_torch/csrc/flash_decode.cu",
                     "livecc_tpu/ops/pallas/attention.py:253"),
    "flash_prefill_int8": ("livecc_tpu_torch/csrc/flash_prefill_int8.cu",
                           "livecc_tpu/ops/pallas/attention.py:78"),
    "flash_decode_int8": ("livecc_tpu_torch/csrc/flash_decode_int8.cu",
                          "livecc_tpu/ops/pallas/attention.py:220"),
    "train_attention_fwd": ("livecc_tpu_torch/csrc/train_attention_fwd.cu",
                            "livecc_tpu/ops/attention.py:126"),
    "train_attention_bwd": ("livecc_tpu_torch/csrc/train_attention_bwd.cu",
                            "livecc_tpu/ops/attention.py:126"),
    # no Pallas kernel: XLA's fused convert + dot of JAX's int8 dense
    "w8a16_gemm": ("livecc_tpu_torch/csrc/w8a16_gemm.cu", "livecc_tpu/ops/quant.py:64"),
}
# the kernels each path must launch
MAIN_KERNELS = ("vit_group_attention", "flash_prefill", "flash_decode")
POOL_KERNELS = ("vit_group_attention", "flash_prefill_int8", "flash_decode_int8")
# lookahead decoding (controller off) runs K1 / K1-int8 in its verify windows
MAIN_SPEC_KERNELS = ("vit_group_attention", "flash_prefill")
POOL_SPEC_KERNELS = ("vit_group_attention", "flash_prefill_int8")
TRAIN_KERNELS = ("vit_group_attention", "train_attention_fwd", "train_attention_bwd")
# int8 weights: every quantized matmul through K5
MAIN_W8_KERNELS = MAIN_KERNELS + ("w8a16_gemm",)
POOL_W8_KERNELS = POOL_KERNELS + ("w8a16_gemm",)
MAIN_W8_SPEC_KERNELS = MAIN_SPEC_KERNELS + ("w8a16_gemm",)
BF16_TOL = 2e-2     # the JAX package's own bf16 bound (tests/test_vit_attention.py:22)
# lookahead against plain decoding on the card: where a stream parts, the
# lookahead's token within TIE_ULPS bf16 steps of the plain run's best logit,
# among its TOP_K (``near_ties``)
TIE_ULPS, TOP_K = 4, 8
FP32_TOL = 1e-4
# H100 SXM: dense bf16 tensor-core peak and HBM3 bandwidth (NVIDIA's data sheet)
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# K4 at the 7B's training heads (Hq, Hk, D) on packed rows: (S, segment
# lengths, then pad as segment 0); the last case is timed, and the one-segment
# yardstick runs at its S
K4_HEADS = (28, 4, 128)
K4_CASES = ((4096, (1500, 1400, 1000), "bf16", True),     # strided q
            (1000, (400, 350, 200), "fp32", False),
            (8192, (2900, 2700, 2300), "bf16", False))
# K4 against the plain version on the same inputs and dtype (same roundings):
# |out - ref| <= rtol |ref| + atol rms(ref) elementwise. bf16's rtol is just
# above one bf16 step (2^-7 relative), which is all a rounding flip moves
# an output; lse is fp32 in both dtypes
K4_TOL = {"bf16": (1e-2, 2e-2), "fp32": (1e-4, 1e-4), "lse": (1e-4, 1e-4)}
K4_GRAD_NORM_TOL = 2e-2    # bf16 gradients against the fp32 plain version: ||g - r|| / ||r||
# eval: VideoMME items at the 720p budget (EVAL_FRAMES frames of a 720x1280
# source at 2 fps, served at the budget's 560x1008: 32 groups of g = 2880,
# the 32768 bucket), the reduced item (8 frames of 560x1008: 4 groups, the
# 4096 bucket), a LiveSports-3K CC event of CC_SECONDS s
EVAL_SOURCE_HW, EVAL_FRAMES, EVAL_FPS = (720, 1280), 64, 2.0
EVAL_REDUCED_HW, EVAL_REDUCED_FRAMES = (560, 1008), 8
EVAL_QUESTIONS = ("What does the player in the red shirt do after the whistle?",
                  "How many players cross the halfway line?")
EVAL_OPTIONS = ("A. He shoots.", "B. He passes.", "C. He falls.", "D. He waves.")
EVAL_KERNELS = ("vit_group_attention", "train_attention_fwd")
CC_SECONDS = 10
# checkpoint_live: a clip of CLIP_SECONDS s at CLIP_FPS frames a second, the CLI's default query
CLIP_SECONDS, CLIP_FPS = 10, 10
QUERY = "Please describe the video."


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    if not os.path.isdir(os.path.join(ROOT, "livecc_tpu_torch")):
        raise SystemExit("chip_smoke: livecc_tpu_torch/ is not beside this script; "
                         "run it from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this test needs "
                         "a CUDA GPU and does not fall back to the CPU")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products stay fp32
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from livecc_tpu_torch.ops import build

    t0 = time.perf_counter()
    lib = build.build_library()
    build.load_library()
    log(f"build: {lib} in {time.perf_counter() - t0:.1f} s")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Function properties for" in line:     # the kernel the next two lines describe
            name = line.split("for ")[-1]
            m = re.search(r"\d+([a-z_]*kernel)(I\w*?)?E+[vN]", name)   # template or not
            log(f"  ptxas: {m.group(1) + (m.group(2) or '') if m else name}")
        elif "Used" in line or "spill" in line or "Performance Loss" in line:
            log(f"  ptxas: {line.strip()}")


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take for work of
    ``flops`` operations that must move ``nbytes``."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def segment_ids(s: int, lengths, dev):
    """int32 [1, s]: segments 1..n of ``lengths``, the rest 0 (pad)."""
    import torch

    seg = torch.zeros((1, s), dtype=torch.int32)
    at = 0
    for i, n in enumerate(lengths):
        seg[0, at:at + n] = i + 1
        at += n
    return seg.to(dev)


def causal_pairs(lengths, s: int) -> int:
    """Query-key pairs that causal attention within each segment (pad
    included) needs."""
    pad = s - sum(lengths)
    return sum(n * (n + 1) // 2 for n in (*lengths, pad))


def phase_kernels() -> dict:
    """Kernel vs plain version on the card; returns per-kernel results."""
    import torch
    import torch.nn.functional as F

    from livecc_tpu_torch.ops.flash_attention import (
        DECODE_SPLIT, flash_decode, flash_decode_plain, flash_prefill, flash_prefill_plain)
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.ops.vit_attention import (
        vit_group_attention, vit_group_attention_plain, vit_segment_attention,
        vit_segment_attention_plain)
    from livecc_tpu_torch.tools import kernel_check, kernel_timing
    from livecc_tpu_torch.tools.kernel_timing import cuda_ms, graph_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # the verify window's queries come from a generator of their own, so
    # every other case keeps its inputs
    window_gen = torch.Generator(device=dev).manual_seed(9)
    bf16, f32 = torch.bfloat16, torch.float32
    results: dict[str, dict] = {}

    def randn(shape, dtype, generator=gen):
        return torch.randn(shape, generator=generator, device=dev, dtype=f32).to(dtype)

    def queries(b, sq, hq, d):
        """bf16 q [B, Hq, Sq, D], strided as the model passes it."""
        g = window_gen if sq == kernel_timing.WINDOW_SQ else gen
        return randn((b, sq, hq, d), bf16, g).transpose(1, 2)

    def check(name, label, out, ref, tol):
        torch.cuda.synchronize()
        out, ref = out.float(), ref.float()
        if out.shape != ref.shape or not torch.isfinite(out).all():
            raise AssertionError(f"{name} {label}: shape {tuple(out.shape)} vs "
                                 f"{tuple(ref.shape)} or non-finite output")
        err = (out - ref).abs().max().item()
        log(f"  {name:20s} {label:48s} max_abs_err {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"{name} {label}: max abs err {err} > {tol}")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)

    def check_decode(label, args, out, timed=False):
        """K2, or K2-int8 when ``args`` = (q, k, v, kv_limit, k_scale, v_scale)
        (one layer) holds scales, against the plain version on the same
        inputs in the same dtype by ``kernel_check.close``. Where the longest
        row has more than one split, the planted fault (the plain version
        with one split dropped, ``kernel_check.drop_split``) must fail the
        same limit. A timed case also checks that a second launch gives the
        same bits."""
        name = "flash_decode" if args[4] is None else "flash_decode_int8"
        dtype = args[0].dtype
        ref = flash_decode_plain(*args)
        worst = kernel_check.close(out, ref, dtype)
        err = (out.float() - ref.float()).abs().max().item()
        note = ""
        if int(args[3].max()) > DECODE_SPLIT:
            fault = kernel_check.drop_split(*args[:4], DECODE_SPLIT, *args[4:])
            w_bad = kernel_check.close(fault, ref, dtype)
            note = f"; a dropped split: {w_bad:.1f}x"
            if not w_bad > 1.0:
                raise AssertionError(f"{name} {label}: the check passes a dropped split")
        log(f"  {name:20s} {label:48s} max_abs_err {err:.3e}, worst {worst:.3f} of the limit "
            f"{kernel_check.TOL[dtype]}{note}")
        if not worst <= 1.0:
            raise AssertionError(f"{name} {label}: {worst:.3f}x the limit")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if timed:
            if not torch.equal(out, flash_decode(*args[:4], None, *args[4:])):
                raise AssertionError(f"{name} {label}: two launches differ")
            log(f"  {name:20s} {label:48s} two launches bit-equal")

    def times(name, label, kernel_fn, plain_fn):
        """The timed case's kernel and plain-version times (``cuda_ms``)."""
        r = results[name]
        r["ms"] = cuda_ms(kernel_fn)
        r["plain_ms"] = cuda_ms(plain_fn)
        log(f"  {name:20s} {label:48s} kernel {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms")

    def yardsticks(name, flops, nbytes, library_fn):
        """The timed case's bound and library time (``cuda_ms``)."""
        r = results[name]
        r["bound_ms"], r["bound_by"] = bound(flops, nbytes)
        r["library_ms"] = None if library_fn is None else cuda_ms(library_fn)
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.3f} ms"
        log(f"  {name:20s} bound {r['bound_ms']:.4f} ms ({r['bound_by']}; {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.3f} MB)  library {lib}")

    def device_times(name, label, kernel_fn, plain_fn, library_fn):
        """Device time (``graph_ms``) of a decode or K1-int8 case's kernel,
        plain version and library call, each by the same method."""
        t = [None if fn is None else graph_ms(fn) for fn in (kernel_fn, plain_fn, library_fn)]
        log(f"  {name:20s} {label:48s} device time: kernel {t[0]:.4f} ms  plain {t[1]:.4f} ms  "
            f"library " + ("none" if t[2] is None else f"{t[2]:.4f} ms"))

    def same_dtype(name, label, out, ref, fault, repeat=None):
        """bf16 K1, K1-int8 or K3 against the plain version on the same
        inputs in the same dtype by ``kernel_check.close``; the planted fault
        (one key tile dropped for one query tile,
        ``kernel_check.drop_key_tile``) must fail the same limit; with
        ``repeat``, a second launch must give the same bits."""
        torch.cuda.synchronize()
        worst, w_bad = kernel_check.close(out, ref, bf16), kernel_check.close(fault, ref, bf16)
        err = (out.float() - ref.float()).abs().max().item()
        log(f"  {name:20s} {label:48s} max_abs_err {err:.3e}, worst {worst:.3f} of the limit "
            f"{kernel_check.TOL[bf16]}; a dropped key tile: {w_bad:.1f}x")
        if not worst <= 1.0:
            raise AssertionError(f"{name} {label}: {worst:.3f}x the limit")
        if not w_bad > 1.0:
            raise AssertionError(f"{name} {label}: the check passes a dropped key tile")
        if repeat is not None:
            if not torch.equal(out, repeat()):
                raise AssertionError(f"{name} {label}: two launches differ")
            log(f"  {name:20s} {label:48s} two launches bit-equal")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)

    def timed_case(name, label, fns, flops, nbytes):
        """Kernel, plain version and library call (SDPA; None for an int8
        cache) at one timed shape, each by both methods (``cuda_ms``: one
        call, host work included; ``graph_ms``: device time), beside the
        bound. The first timed shape of a kernel gives its JSON numbers."""
        one = [None if fn is None else cuda_ms(fn) for fn in fns]
        dev_t = [None if fn is None else graph_ms(fn) for fn in fns]
        b_ms, b_by = bound(flops, nbytes)
        lib = lambda t: "none" if t is None else f"{t:.4f}"
        log(f"  {name:20s} {label:48s} one call: kernel {one[0]:.4f}  plain {one[1]:.4f}  "
            f"library {lib(one[2])} ms; device: kernel {dev_t[0]:.4f}  plain {dev_t[1]:.4f}  "
            f"library {lib(dev_t[2])} ms; bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.3f} MB)")
        r = results[name]
        if "ms" not in r:
            r.update(ms=one[0], plain_ms=one[1], library_ms=one[2], bound_ms=b_ms, bound_by=b_by)

    # K3: the ViT (H = 16, D = 80) at kernel_timing's timed shapes (the first
    # and a steady chunk at the 720p budget, g = 880 = 22 x 40; the training
    # call, whose shape phase_train checks), g = 308 untimed, fp32
    vh, vd = kernel_timing.VIT_HEADS, kernel_timing.VIT_DIM
    vit_cases = [(ng, g, bf16, True) for ng, g in kernel_timing.VIT_SHAPES]
    for ng, g, dtype, timed in vit_cases + [(3, 308, bf16, False), (1, 308, f32, False)]:
        q, k, v = (randn((ng, g, vh, vd), dtype) for _ in range(3))
        label = f"NG={ng} g={g} H={vh} D={vd} {str(dtype)[6:]}"
        out = vit_group_attention(q, k, v)
        if dtype == f32:
            check("vit_group_attention", label, out, vit_group_attention_plain(q, k, v), FP32_TOL)
            continue
        ref = vit_group_attention_plain(q, k, v)
        cu = list(range(0, (ng + 1) * g, g))
        qn, kn, vn, rn = (x.reshape(ng * g, vh, vd) for x in (q, k, v, ref))
        fault = kernel_check.vit_drop_key_tile(rn, qn, kn, vn, cu, ng - 1, (g - 1) // 64,
                                               g // 128, head=3)
        same_dtype("vit_group_attention", label, out, ref, fault.view(ref.shape),
                   (lambda: vit_group_attention(q, k, v)) if timed else None)
        if timed:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))          # [NG, H, g, D]
            timed_case("vit_group_attention", label,
                       (lambda: vit_group_attention(q, k, v),
                        lambda: vit_group_attention_plain(q, k, v),
                        lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                       4 * ng * vh * g * g * vd, 4 * q.numel() * 2)
        del q, k, v, out, ref, fault
    # mixed sizes through the bounds form: [N, H, D] with v a strided view of
    # a qkv buffer as the tower holds it; bf16 and fp32
    for lengths, dtype in (((880, 308, 544, 100), bf16), ((70, 130, 5), f32)):
        n = sum(lengths)
        cu = [0]
        for length in lengths:
            cu.append(cu[-1] + length)
        qkv = randn((n, 3 * vh, vd), dtype)
        q, k, v = qkv[:, :vh].contiguous(), qkv[:, vh:2 * vh].contiguous(), qkv[:, 2 * vh:]
        cu_t = torch.tensor(cu, dtype=torch.int32, device=dev)
        label = f"segments {list(lengths)} H={vh} D={vd} {str(dtype)[6:]}"
        before = build.launch_counts["vit_group_attention"]
        out = vit_segment_attention(q, k, v, cu_t, max(lengths))
        if build.launch_counts["vit_group_attention"] != before + 1:
            raise AssertionError(f"vit_segment_attention {label}: not one K3 launch")
        ref = vit_segment_attention_plain(q, k, v, cu)
        if dtype == f32:
            check("vit_group_attention", label, out, ref, FP32_TOL)
        else:
            same_dtype("vit_group_attention", label, out, ref,
                       kernel_check.vit_drop_key_tile(ref, q, k, v, cu, 0, 13, 6, head=3),
                       lambda: vit_segment_attention(q, k, v, cu_t, max(lengths)))
        del qkv, q, k, v, out, ref

    # K1 / K2: the 7B's cache [L=28, B, Hk=4, Smax=8192, D=128], layer 27
    L, hq, hk, d, smax, li = 28, 28, 4, 128, 8192, 27
    for b in (1, 2):
        k5, v5 = (randn((L, b, hk, smax, d), bf16) for _ in range(2))
        if b == 1:
            prefill_cases = [(sq, [off], [lim], True)
                             for sq, off, lim in kernel_timing.PREFILL_SHAPES]
        else:
            prefill_cases = [(256, [0, 1500], [200, 1756], False)]
        for sq, off, lim, timed in prefill_cases:
            q = queries(b, sq, hq, d)
            off_t = torch.tensor(off, dtype=torch.int32, device=dev)
            lim_t = torch.tensor(lim, dtype=torch.int32, device=dev)
            label = f"B={b} Sq={sq} offset={off} kv_limit={lim} bf16"
            out = flash_prefill(q, k5, v5, off_t, lim_t, layer_index=li)
            ref = flash_prefill_plain(q, k5[li], v5[li], off_t, lim_t)
            row = max(range(b), key=lambda i: lim[i])       # the longest row, its last query tile
            qt = (sq - 1) // 64
            kt = min(lim[row], off[row] + 64 * qt + 1) // 64 // 2
            fault = kernel_check.drop_key_tile(ref, q, k5[li], v5[li], off_t, lim_t, qt, kt,
                                               head=5, row=row)
            same_dtype("flash_prefill", label, out, ref, fault,
                       (lambda: flash_prefill(q, k5, v5, off_t, lim_t, layer_index=li))
                       if timed else None)
            del ref, fault
            if timed:      # B = 1: keys < kv_limit and <= offset + i
                kv = lim[0]
                pairs = sum(min(off[0] + i + 1, kv) for i in range(sq))
                kq, vq = k5[li][:, :, :kv], v5[li][:, :, :kv]
                qpos = off[0] + torch.arange(sq, device=dev)[:, None]
                mask = torch.arange(kv, device=dev)[None, :] <= qpos
                timed_case("flash_prefill", label,
                           (lambda: flash_prefill(q, k5, v5, off_t, lim_t, layer_index=li),
                            lambda: flash_prefill_plain(q, k5[li], v5[li], off_t, lim_t),
                            lambda: F.scaled_dot_product_attention(q, kq, vq, attn_mask=mask,
                                                                   enable_gqa=True)),
                           4 * pairs * d * hq, 2 * q.numel() * 2 + 2 * b * hk * kv * d * 2)
        limits = [[1], [777], [8192]] if b == 1 else [[1, 8192], [777, 3]]
        for lim in limits:
            q = randn((b, hq, 1, d), bf16)
            lim_t = torch.tensor(lim, dtype=torch.int32, device=dev)
            out = flash_decode(q, k5, v5, lim_t, layer_index=li)
            timed = b == 1 and lim == [777]
            label = f"B={b} kv_limit={lim} bf16"
            check_decode(label, (q, k5[li], v5[li], lim_t, None, None), out, timed)
            if timed:
                valid = (torch.arange(smax, device=dev)[None, :] < lim_t[:, None])[:, None, None]
                fns = (lambda: flash_decode(q, k5, v5, lim_t, layer_index=li),
                       lambda: flash_decode_plain(q, k5[li], v5[li], lim_t),
                       lambda: F.scaled_dot_product_attention(q, k5[li], v5[li], attn_mask=valid,
                                                              enable_gqa=True))
                times("flash_decode", label, *fns[:2])
                yardsticks("flash_decode", 4 * sum(lim) * d * hq,
                           2 * q.numel() * 2 + 2 * hk * sum(lim) * d * 2, fns[2])
                device_times("flash_decode", label, *fns)
        del k5, v5
    # a query group wider than one decode block (G * D = 32 x 128 = 4096):
    # the wrapper runs it as two sub-groups, two launches
    k5, v5 = (randn((2, 1, 1, 4096, d), bf16) for _ in range(2))
    q = randn((1, 32, 1, d), bf16)
    lim_t = torch.tensor([3000], dtype=torch.int32, device=dev)
    before = build.launch_counts["flash_decode"]
    out = flash_decode(q, k5, v5, lim_t, layer_index=1)
    if build.launch_counts["flash_decode"] != before + 2:
        raise AssertionError("flash_decode Hq=32 Hk=1: not two launches")
    check_decode("B=1 Hq=32 Hk=1 D=128 kv_limit=[3000] bf16", (q, k5[1], v5[1], lim_t, None, None),
                 out)
    del k5, v5
    # fp32 cases (the tiny end-to-end run's dtype), strided q as the text tower passes it
    k4, v4 = (randn((2, 2, 512, 16), f32) for _ in range(2))
    qs = randn((2, 100, 4, 16), f32).transpose(1, 2)
    off_t = torch.tensor([37, 300], dtype=torch.int32, device=dev)
    lim_t = torch.tensor([137, 400], dtype=torch.int32, device=dev)
    check("flash_prefill", "B=2 Sq=100 D=16 strided q fp32", flash_prefill(qs, k4, v4, off_t, lim_t),
          flash_prefill_plain(qs, k4, v4, off_t, lim_t), FP32_TOL)
    q1 = randn((2, 4, 1, 16), f32)
    check_decode("B=2 D=16 fp32", (q1, k4, v4, lim_t, None, None), flash_decode(q1, k4, v4, lim_t))
    del k4, v4, qs, q1

    # K1-int8 / K2-int8 on the pool's cache: [28, 8, 4, 8192, 128] int8 with
    # lane-major bf16 scales [28, 8, 4, 1, 8192], layer 27; the verify window
    # (Sq = 9 at the steady tick's depths) last, timed but not in the JSON line
    from livecc_tpu_torch.models.qwen2_vl.text import quantize_kv

    def int8_cache(shape):
        codes, scale = quantize_kv(randn(shape, bf16))
        return codes, scale.transpose(-1, -2).contiguous()

    b = 8
    (k8, ks8), (v8, vs8) = (int8_cache((L, b, hk, smax, d)) for _ in range(2))
    layer = (k8[li], v8[li], ks8[li], vs8[li])
    sq8 = kernel_timing.INT8_SQ
    solo_sq, solo_off, solo_lim = kernel_timing.INT8_SOLO
    # (queries, offsets, kv limits, timed): the timed pool tick, a steady
    # tick, the solo init chunk (batch row 0 of the cache), a verify window
    wsq = kernel_timing.WINDOW_SQ
    for sq_i, offs, lims, timed in ((sq8, kernel_timing.INT8_POOL_OFFSETS, None, True),
                                    (sq8, kernel_timing.INT8_STEADY_OFFSETS, None, False),
                                    (solo_sq, (solo_off,), (solo_lim,), False),
                                    (wsq, kernel_timing.INT8_STEADY_OFFSETS, None, "window")):
        n = len(offs)
        lims = lims or tuple(o + sq_i for o in offs)
        cache = tuple(x[:, :n] for x in (k8, v8, ks8, vs8))
        one = tuple(x[li] for x in cache)
        off_t = torch.tensor(offs, dtype=torch.int32, device=dev)
        lim_t = torch.tensor(lims, dtype=torch.int32, device=dev)
        if n == 1:      # the steady tick's queries, its first 4 rows of 256 as one of 1024
            q = q.transpose(1, 2).reshape(1, -1, hq, d)[:, :sq_i].transpose(1, 2)
        else:           # strided, as the model passes it
            q = queries(n, sq_i, hq, d)
        label = f"B={n} Sq={sq_i} offset={list(offs)} kv_limit={list(lims)} bf16"
        fns = (lambda: flash_prefill(q, cache[0], cache[1], off_t, lim_t, layer_index=li,
                                     k_scale=cache[2], v_scale=cache[3]),
               lambda: flash_prefill_plain(q, *one[:2], off_t, lim_t, *one[2:]))
        out, ref = fns[0](), fns[1]()
        row = max(range(n), key=lambda i: lims[i])             # the deepest row, its last tile
        qt = (sq_i - 1) // 64
        kt = min(lims[row], offs[row] + 64 * qt + 1) // 64 // 2
        fault = kernel_check.drop_key_tile(ref, q, *one[:2], off_t, lim_t, qt, kt, head=5,
                                           row=row, k_scale=one[2], v_scale=one[3])
        same_dtype("flash_prefill_int8", label, out, ref, fault, fns[0])
        del ref, fault
        # the split of p * v_scale: the roundings of the fp32 plain version
        ref32 = flash_prefill_plain(q.float(), *one[:2], off_t, lim_t, *one[2:])
        flips = kernel_check.rounding_flips(out, ref32)
        one_part = kernel_check.rounding_flips(
            kernel_check.one_part_pv(q, *one[:2], off_t, lim_t, *one[2:]).to(bf16), ref32)
        log(f"  {'flash_prefill_int8':20s} {label:48s} {flips:.2e} of the outputs round off the "
            f"fp32 plain version's bf16 (limit {kernel_check.FLIP_LIMIT:g}); p * v_scale as one "
            f"bf16 part: {one_part:.3f}")
        if not flips <= kernel_check.FLIP_LIMIT:
            raise AssertionError(f"flash_prefill_int8 {label}: {flips} of the outputs round off "
                                 f"the fp32 result, past {kernel_check.FLIP_LIMIT}")
        if not one_part > kernel_check.FLIP_LIMIT:
            raise AssertionError(f"flash_prefill_int8 {label}: the rounding check passes p * "
                                 f"v_scale as one bf16 part")
        del out, ref32
        pairs = sum(sq_i * o + sq_i * (sq_i + 1) // 2 for o in offs)
        work = (4 * pairs * d * hq, 2 * q.numel() * 2 + 2 * hk * sum(lims) * (d + 2))
        if timed == "window":
            timed_case("flash_prefill_int8", label, (*fns, None), *work)
        elif timed:
            times("flash_prefill_int8", label, *fns)
            yardsticks("flash_prefill_int8", *work, None)
        if timed != "window":
            device_times("flash_prefill_int8", label, *fns, None)
        del cache, one
    lim_d = torch.tensor([1, 777, 8192, 4000, 1, 777, 8192, 2500], dtype=torch.int32, device=dev)
    q = randn((b, 1, hq, d), bf16).transpose(1, 2)
    label = f"B=8 kv_limit={lim_d.tolist()} bf16"
    check_decode(label, (q, *layer[:2], lim_d, *layer[2:]),
                 flash_decode(q, k8, v8, lim_d, layer_index=li, k_scale=ks8, v_scale=vs8), True)
    fns = (lambda: flash_decode(q, k8, v8, lim_d, layer_index=li, k_scale=ks8, v_scale=vs8),
           lambda: flash_decode_plain(q, *layer[:2], lim_d, *layer[2:]))
    times("flash_decode_int8", label, *fns)
    keys = sum(lim_d.tolist())
    yardsticks("flash_decode_int8", 4 * keys * d * hq, 2 * q.numel() * 2 + 2 * hk * keys * (d + 2),
               None)
    device_times("flash_decode_int8", label, *fns, None)
    del k8, v8, ks8, vs8, layer
    # bf16 K2 at the pool's B = 8 and the same limits, beside K2-int8
    k5, v5 = (randn((L, b, hk, smax, d), bf16) for _ in range(2))
    check_decode(f"B=8 kv_limit={lim_d.tolist()} bf16", (q, k5[li], v5[li], lim_d, None, None),
                 flash_decode(q, k5, v5, lim_d, layer_index=li), True)
    valid = (torch.arange(smax, device=dev)[None, :] < lim_d[:, None])[:, None, None]
    fns = (lambda: flash_decode(q, k5, v5, lim_d, layer_index=li),
           lambda: flash_decode_plain(q, k5[li], v5[li], lim_d),
           lambda: F.scaled_dot_product_attention(q, k5[li], v5[li], attn_mask=valid,
                                                  enable_gqa=True))
    b8 = [cuda_ms(fn) for fn in fns]
    keys = sum(lim_d.tolist())
    b8_bound = bound(4 * keys * d * hq, 2 * q.numel() * 2 + 2 * hk * keys * d * 2)
    label = "B=8 (pool shape) bf16 cache"
    log(f"  {'flash_decode':20s} {label:48s} kernel {b8[0]:.3f} ms  plain {b8[1]:.3f} ms  "
        f"bound {b8_bound[0]:.4f} ms ({b8_bound[1]})  library {b8[2]:.3f} ms")
    device_times("flash_decode", label, *fns)
    del k5, v5
    # fp32 queries on an int8 cache (the tiny pool's dtypes)
    (k4, ks4), (v4, vs4) = (int8_cache((2, 2, 512, 16)) for _ in range(2))
    qs = randn((2, 100, 4, 16), f32).transpose(1, 2)
    off_t = torch.tensor([37, 300], dtype=torch.int32, device=dev)
    lim_t = torch.tensor([137, 400], dtype=torch.int32, device=dev)
    check("flash_prefill_int8", "B=2 Sq=100 D=16 strided q fp32",
          flash_prefill(qs, k4, v4, off_t, lim_t, k_scale=ks4, v_scale=vs4),
          flash_prefill_plain(qs, k4, v4, off_t, lim_t, ks4, vs4), FP32_TOL)
    q1 = randn((2, 4, 1, 16), f32)
    check_decode("B=2 D=16 fp32", (q1, k4, v4, lim_t, ks4, vs4),
                 flash_decode(q1, k4, v4, lim_t, k_scale=ks4, v_scale=vs4))
    del k4, v4, ks4, vs4, qs, q1
    torch.cuda.empty_cache()
    phase_k4(results, check, times, yardsticks, randn)
    torch.cuda.empty_cache()
    phase_k5(results)
    torch.cuda.empty_cache()
    return results


def phase_k4(results, check, times, yardsticks, randn):
    """K4 forward and backward against the plain version at the training
    shape: packed rows of 4096 (bf16, strided q), 1000 (fp32) and 8192
    (bf16, timed, with the bound and the library call on the same inputs);
    then the one-segment yardstick against SDPA's causal kernel.

    o and lse, and fp32 gradients, are held to the plain version on the
    same inputs in the same dtype, which rounds p and ds as the kernels do,
    elementwise within ``rtol * |ref| + atol * rms(ref)`` (``K4_TOL``). bf16
    gradients (dq, dk, dv) are held to the plain version in fp32 by
    ``kernel_check.grad_close``: within bf16's rtol of the fp32 value plus
    twice the bf16 plain version's worst stray from fp32 in the same row
    and a thousandth of the gradient's rms (a gradient sums thousands of
    bf16-rounded terms, and two valid roundings of it can differ past the
    elementwise limit). The
    backward's references take the backward kernel's own inputs, the forward
    kernel's o and lse (themselves held to the plain forward): fed the plain
    forward's lse instead, a p that sits on a bf16 rounding tie rounds the
    other way, and one such term (p 0.557, |do| 2.58) moves a dv element by
    one bf16 step of p times do. Each check must fail a
    planted fault, the reference with one 64 x 64 tile pair dropped
    (``kernel_check.dropped_tile``), or the script fails: a limit that
    passes it could not see a skipped tile. bf16 cases are also
    held to the plain version in fp32 (o within ``BF16_TOL``, each gradient
    within ``K4_GRAD_NORM_TOL`` norm-relative) and must give the same bits
    in a second launch. The timed case gives one-call times (``cuda_ms``)
    of kernel, plain version and SDPA, and the kernel's device time
    (``graph_ms``)."""
    import torch
    import torch.nn.functional as F

    from livecc_tpu_torch.ops.attention import prescaled
    from livecc_tpu_torch.ops.train_attention import (
        train_attention_bwd, train_attention_bwd_plain, train_attention_fwd,
        train_attention_fwd_plain)
    from livecc_tpu_torch.tools import kernel_check
    from livecc_tpu_torch.tools.kernel_timing import cuda_ms, graph_ms

    dev = torch.device("cuda")
    hq, hk, d = K4_HEADS

    def inputs(s, dtype, strided):
        q = randn((1, hq, s, d), dtype).transpose(1, 2) if strided else randn((1, s, hq, d), dtype)
        return (prescaled(q), randn((1, s, hk, d), dtype), randn((1, s, hk, d), dtype),
                randn((1, s, hq, d), dtype))

    def worst(out, ref, rtol, atol):
        """max |out - ref| / (rtol |ref| + atol rms(ref)): 1 is the limit."""
        out, ref = out.float(), ref.float()
        if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"K4: shape {tuple(out.shape)} vs {tuple(ref.shape)} or "
                                 f"non-finite output")
        lim = rtol * ref.abs() + atol * ref.square().mean().sqrt()
        return ((out - ref).abs() / lim).max().item()

    for i, (s, lengths, kind, strided) in enumerate(K4_CASES):
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        qs, k, v, do = inputs(s, dtype, strided)
        seg = segment_ids(s, lengths, dev)
        label = f"S={s} segments {list(lengths)} {kind}{' strided q' if strided else ''}"
        o, lse = train_attention_fwd(qs, k, v, seg)
        grads = train_attention_bwd(qs, k, v, seg, o, lse, do)
        ro, rlse = train_attention_fwd_plain(qs, k, v, seg)
        rgrads = train_attention_bwd_plain(qs, k, v, seg, o, lse, do)
        if kind == "bf16":      # the plain version in fp32 on the same inputs
            f32 = [x.float() for x in (qs, k, v)]
            ro32, rlse32 = train_attention_fwd_plain(*f32, seg)
            rgrads32 = train_attention_bwd_plain(*f32, seg, ro32, rlse32, do.float())
        qt = lengths[0] // 64 - 1                    # a query tile at the end of segment 1
        fault = (*kernel_check.dropped_tile(qs, k, v, seg, do, ro, rlse, rgrads, qt, qt // 2,
                                            3)[:2],
                 *kernel_check.dropped_tile(qs, k, v, seg, do, o, lse, rgrads, qt, qt // 2,
                                            3)[2:])
        torch.cuda.synchronize()
        outs = zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *grads), (ro, rlse, *rgrads), fault)
        for j, (part, out, ref, bad) in enumerate(outs):
            name = "train_attention_fwd" if part in ("o", "lse") else "train_attention_bwd"
            if kind == "bf16" and j >= 2:       # a bf16 gradient: against fp32
                r32 = rgrads32[j - 2]
                w, w_bad = (kernel_check.grad_close(x, ref, r32) for x in (out, bad))
                limit = (f"rtol 1e-2 x |ref32| + {kernel_check.GRAD_SPREAD:g} x the bf16 plain "
                         f"version's row max |ref - ref32| + {kernel_check.GRAD_FLOOR:g} x "
                         f"rms(ref32)")
            else:
                rtol, atol = K4_TOL["lse" if part == "lse" else kind]
                w, w_bad = worst(out, ref, rtol, atol), worst(out, bad, rtol, atol)
                limit = f"rtol {rtol:g}, atol {atol:g} x rms"
            err = (out.float() - ref.float()).abs().max().item()
            log(f"  {name:20s} {label} {part}: max_abs_err {err:.3e}, worst {w:.3f} of the limit "
                f"({limit}); a dropped tile pair: {w_bad:.1f}x")
            if not w <= 1.0:
                raise AssertionError(f"{name} {label} {part}: {w:.3f}x the limit")
            if not w_bad > 1.0:
                raise AssertionError(f"{name} {label} {part}: the check passes a dropped tile")
            if part != "lse":
                r = results.setdefault(name, {"max_abs_err": 0.0})
                r["max_abs_err"] = max(r["max_abs_err"], err)
        del rgrads, fault
        if kind == "bf16":
            check("train_attention_fwd", f"{label} o vs fp32 plain", o, ro32, BF16_TOL)
            for part, g, r in zip(("dq", "dk", "dv"), grads, rgrads32):
                rel = (torch.linalg.vector_norm(g.float() - r) / torch.linalg.vector_norm(r)).item()
                log(f"  {'train_attention_bwd':20s} {label} {part} vs fp32 plain: norm-relative "
                    f"{rel:.3e} (tol {K4_GRAD_NORM_TOL:g})")
                if not rel <= K4_GRAD_NORM_TOL:
                    raise AssertionError(f"train_attention_bwd {label} {part}: {rel} vs fp32")
            del f32, ro32, rlse32, rgrads32
            again = (*train_attention_fwd(qs, k, v, seg), *train_attention_bwd(qs, k, v, seg, o,
                                                                               lse, do))
            if not all(torch.equal(a, b) for a, b in zip((o, lse, *grads), again)):
                raise AssertionError(f"train_attention {label}: two launches differ")
            log(f"  {'train_attention':20s} {label}: two launches bit-equal (o, lse, dq, dk, dv)")
            del again
        del ro, rlse
        torch.cuda.empty_cache()
        if i == len(K4_CASES) - 1:          # timed
            fwd_fns = (lambda: train_attention_fwd(qs, k, v, seg),
                       lambda: train_attention_fwd_plain(qs, k, v, seg))
            bwd_fns = (lambda: train_attention_bwd(qs, k, v, seg, o, lse, do),
                       lambda: train_attention_bwd_plain(qs, k, v, seg, o, lse, do))
            times("train_attention_fwd", label, *fwd_fns)
            times("train_attention_bwd", label, *bwd_fns)
            pairs = causal_pairs(lengths, s)
            io = 2 * (2 * s * hq * d + 2 * s * hk * d)          # q, o, k, v in bf16
            fwd_lib, bwd_lib = sdpa_packed(qs, k, v, seg, None), sdpa_packed(qs, k, v, seg, do)
            yardsticks("train_attention_fwd", 4 * pairs * d * hq, io + 4 * s * hq + 4 * s,
                       fwd_lib)
            yardsticks("train_attention_bwd", 10 * pairs * d * hq,
                       io + 2 * s * hq * d + 3 * (2 * s * hk * d) + 4 * s * hq + 4 * s,
                       bwd_lib)
            for name, fn in (("train_attention_fwd", fwd_fns[0]),
                             ("train_attention_bwd", bwd_fns[0])):
                r = results[name]
                r["graph_ms"] = graph_ms(fn)
                log(f"  {name:20s} {label} kernel: one call {r['ms']:.4f} ms, device time "
                    f"{r['graph_ms']:.4f} ms")
            del fwd_lib, bwd_lib
        del qs, k, v, do, o, lse, grads
        torch.cuda.empty_cache()

    # the one-segment yardstick: K4 and SDPA's causal kernel, fwd and fwd+bwd
    s = K4_CASES[-1][0]
    qs, k, v, do = inputs(s, torch.bfloat16, False)
    seg = segment_ids(s, (s,), dev)
    fwd = cuda_ms(lambda: train_attention_fwd(qs, k, v, seg))
    o, lse = train_attention_fwd(qs, k, v, seg)
    both = fwd + cuda_ms(lambda: train_attention_bwd(qs, k, v, seg, o, lse, do))
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (qs, k, v, do))
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=1.0,
                                                             enable_gqa=True))
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]

    def lib_both():
        out = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=1.0, enable_gqa=True)
        torch.autograd.grad(out, leaves, dot)

    lib = cuda_ms(lib_both)
    flops = 4 * (s * (s + 1) // 2) * d * hq
    log(f"  {'train_attention':20s} one segment S={s}: K4 fwd {fwd:.3f} ms, fwd+bwd {both:.3f} ms; "
        f"SDPA causal fwd {lib_fwd:.3f} ms, fwd+bwd {lib:.3f} ms; bound fwd "
        f"{flops / PEAK_FLOPS * 1e3:.4f} ms, fwd+bwd {3.5 * flops / PEAK_FLOPS * 1e3:.4f} ms")
    results["train_attention_fwd"]["one_segment"] = {"ms": fwd, "library_ms": lib_fwd}
    results["train_attention_bwd"]["one_segment"] = {"fwd_bwd_ms": both, "library_fwd_bwd_ms": lib}


def phase_k5(results):
    """K5 (``w8a16_gemm``) against its plain version at
    ``kernel_timing.W8_SHAPES`` (the 7B's decode rows M = 1 and 8, verify
    windows of 9 and 72 rows on gate_proj, down_proj, k_proj and the fp32
    lm_head; prefill chunks of 256 and 1024 rows on gate_proj; the ViT's fc1
    at 3520 patches), bf16 x, int8 codes and bf16 scales of a weight ~
    N(0, 1/K), held to the plain version in the output's dtype (bf16, or
    fp32 for the lm_head) by ``kernel_check.close``, which a planted fault
    must fail: a dropped K split of one column block in the small form
    (M <= 16, ``kernel_check.w8_drop_split``), one dropped 64-wide K stage
    of one output tile of ``quant.large_plan``'s tiling in the large form
    (``w8_drop_k_tile``). Two launches must be bit-equal. Times, each by
    both methods: kernel, plain version and torch.mm on the bf16 weight (the
    product the bf16 model runs; with an fp32 output for the lm_head),
    beside the bound (``kernel_timing.w8_work``) and the bf16 product's.
    The first shape gives the JSON line's numbers."""
    import torch

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(5)
    r = results.setdefault("w8a16_gemm", {"max_abs_err": 0.0})
    # the plain version's bf16 product sums in fp32 throughout, as K5 does
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        k5_shapes(r, gen)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    log(f"  {'w8a16_gemm':20s} two launches bit-equal at every shape")


def k5_shapes(r: dict, gen) -> None:
    """``phase_k5``'s checks and times, shape by shape, into ``r``."""
    import torch

    from livecc_tpu_torch.ops import quant
    from livecc_tpu_torch.tools import kernel_check, kernel_timing
    from livecc_tpu_torch.tools.kernel_timing import cuda_ms, graph_ms

    for proj, m in kernel_timing.W8_SHAPES:
        x, q, scale, out_dtype = kernel_timing.w8_operands(proj, m, gen)
        n, k = q.shape
        dtype = out_dtype or torch.bfloat16
        label = f"{proj} M={m} N={n} K={k} {str(dtype)[6:]} out"
        out = quant.w8a16_gemm(x, q, scale, out_dtype)
        ref = quant.w8a16_gemm_plain(x, q, scale, out_dtype)
        small = m <= quant.SMALL_M
        fault = (kernel_check.w8_drop_split(x, q, scale, out_dtype) if small
                 else kernel_check.w8_drop_k_tile(x, q, scale, out_dtype))
        plan = (f"small form, splits {quant.small_split(n, k)}" if small else
                f"large form, (token tile, nsplit, split_k) {quant.large_plan(m, n, k)}")
        torch.cuda.synchronize()
        worst, w_bad = kernel_check.close(out, ref, dtype), kernel_check.close(fault, ref, dtype)
        err = (out.float() - ref.float()).abs().max().item()
        log(f"  {'w8a16_gemm':20s} {label:48s} max_abs_err {err:.3e}, worst {worst:.3f} of the "
            f"limit {kernel_check.TOL[dtype]}; a dropped "
            f"{'K split' if small else '64-wide K stage'}: {w_bad:.1f}x; {plan}")
        if not worst <= 1.0:
            raise AssertionError(f"w8a16_gemm {label}: {worst:.3f}x the limit")
        if not w_bad > 1.0:
            raise AssertionError(f"w8a16_gemm {label}: the check passes the planted fault")
        if not torch.equal(out, quant.w8a16_gemm(x, q, scale, out_dtype)):
            raise AssertionError(f"w8a16_gemm {label}: two launches differ")
        r["max_abs_err"] = max(r["max_abs_err"], err)
        del out, ref, fault
        w = q.to(torch.bfloat16) * scale[:, None]        # the bf16 weight
        fns = (lambda: quant.w8a16_gemm(x, q, scale, out_dtype),
               lambda: quant.w8a16_gemm_plain(x, q, scale, out_dtype),
               (lambda: torch.mm(x, w.t())) if out_dtype is None
               else (lambda: torch.mm(x, w.t(), out_dtype=out_dtype)))
        one = [cuda_ms(fn) for fn in fns]
        dev_t = [graph_ms(fn) for fn in fns]
        flops, nbytes = kernel_timing.w8_work(m, n, k, out_dtype is not None)
        b_ms, b_by = bound(flops, nbytes)
        bf16_ms, _ = bound(flops, nbytes + n * k)                 # 2 bytes a weight
        log(f"  {'w8a16_gemm':20s} {label:48s} one call: kernel {one[0]:.4f}  plain {one[1]:.4f}  "
            f"torch.mm bf16 {one[2]:.4f} ms; device: kernel {dev_t[0]:.4f}  plain "
            f"{dev_t[1]:.4f}  torch.mm bf16 {dev_t[2]:.4f} ms; bound {b_ms:.4f} ms ({b_by}; "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB), bf16 weight's {bf16_ms:.4f} ms")
        if "ms" not in r:
            r.update(ms=one[0], plain_ms=one[1], library_ms=one[2], bound_ms=b_ms, bound_by=b_by)
        del x, q, scale, w, fns
        torch.cuda.empty_cache()


def sdpa_packed(qs, k, v, seg, do):
    """The one PyTorch call that computes K4's function on these inputs:
    SDPA with the packed rows' block-causal mask and GQA (forward, or with
    ``do`` the backward of a forward made outside the timing)."""
    import torch
    import torch.nn.functional as F

    s = qs.shape[1]
    pos = torch.arange(s, device=qs.device)
    mask = ((seg[0][:, None] == seg[0][None, :]) & (pos[None, :] <= pos[:, None]))[None, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (qs, k, v))
    if do is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=1.0,
                                                      enable_gqa=True)
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=1.0, enable_gqa=True)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True)


def phase_tiny():
    import copy

    import torch

    from livecc_tpu_torch.core.config import tiny_config
    from livecc_tpu_torch.data.tokenizer import ByteTokenizer
    from livecc_tpu_torch.engine import LiveCCEngine
    from livecc_tpu_torch.models.qwen2_vl import init_params
    from livecc_tpu_torch.tools.session import synth_frames

    cfg = tiny_config()
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    frames = synth_frames(10, 28, 28, seed=1)          # 6-frame chunk + two 2-frame chunks
    outs = []
    for model in (cpu_model, gpu_model):
        eng = LiveCCEngine(model, cfg, ByteTokenizer(), cache_len=512, cache_dtype=torch.float32)
        outs.append(eng.live_cc_once_for_evaluation("describe", frames, max_new_tokens=16))
    log(f"  tiny cpu: {outs[0]}")
    log(f"  tiny gpu: {outs[1]}")
    if len(outs[0]) != 3 or outs[0] != outs[1]:
        raise AssertionError("tiny end to end: CPU and GPU engines disagree")
    mixed_vit(cfg, cpu_model)


def mixed_vit(cfg, cpu_model):
    """A mixed-size ViT call (two clips of different grids, so no uniform
    group): the tiny tower on the card runs K3's bounds form, one launch per
    block, fp32 and bf16; the same tower on the CPU runs the plain version.
    Held norm-relative: fp32 within 1e-5, bf16 within 2e-2."""
    import copy

    import numpy as np
    import torch

    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.ops.rope import vision_rotary_cos_sin
    from livecc_tpu_torch.tools.session import synth_frames
    from livecc_tpu_torch.vision_io.patchify import device_patchify, grid_for_frames

    clips = [synth_frames(4, 56, 28, seed=2), synth_frames(2, 28, 84, seed=3)]
    grids = [grid_for_frames(*f.shape[:3], cfg.vision) for f in clips]
    patches = torch.cat([device_patchify(torch.from_numpy(f)) for f in clips])
    seg = np.concatenate([np.repeat(np.arange(t) + 100 * i, h * w)
                          for i, (t, h, w) in enumerate(grids)]).astype(np.int32)
    cos, sin = (torch.from_numpy(x) for x in vision_rotary_cos_sin(grids, cfg.vision.head_dim))
    args = (patches, cos, sin, torch.from_numpy(seg))
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        tower = copy.deepcopy(cpu_model.visual).to(dtype)
        with torch.no_grad():
            ref = tower(*args).float()
            tower = tower.to("cuda")
            before = build.launch_counts["vit_group_attention"]
            out = tower(*(x.to("cuda") for x in args)).float().cpu()
        launches = build.launch_counts["vit_group_attention"] - before
        rel = (torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref)).item()
        log(f"  mixed-size ViT grids {grids} {str(dtype)[6:]}: {launches} K3 launches, "
            f"norm-relative {rel:.2e} against the CPU (tol {tol:g})")
        if launches != cfg.vision.depth or not rel <= tol:
            raise AssertionError(f"mixed-size ViT {dtype}: {launches} launches, {rel:.2e}")


def phase_tiny_pool():
    """The serving pool on the tiny model, int8 cache: CPU (plain versions)
    against GPU (kernels), text for text."""
    import copy

    import torch

    from livecc_tpu_torch.core.config import tiny_config
    from livecc_tpu_torch.data.tokenizer import ByteTokenizer
    from livecc_tpu_torch.models.qwen2_vl import init_params
    from livecc_tpu_torch.tools import session

    cfg = tiny_config()
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    outs = []
    for model in (cpu_model, copy.deepcopy(cpu_model).to("cuda")):
        server = session.pool_server(cfg, model, ByteTokenizer(), capacity=3, cache_len=512)
        out, _ = session.run_pool(server, n_streams=2, steady_ticks=3, height=28, width=28, seed=1)
        outs.append(out)
        for sid, rows in out.items():
            log(f"  tiny pool {model.text.embed.weight.device.type} stream {sid}: "
                f"{[text for _, text in rows]}")
    if outs[0] != outs[1] or any(len(rows) != 4 for rows in outs[1].values()):
        raise AssertionError("tiny pool: CPU and GPU servers disagree")


def phase_tiny_w8():
    """The tiny config with int8 weights (``quantize_model``), fp32: the
    engine on the CPU (plain versions, the eager decode loop) and on the
    GPU (K5's fp32 form, the decode graphs) give identical greedy text over
    3 chunks, and the GPU run launched K5."""
    import copy

    import torch

    from livecc_tpu_torch.core.config import tiny_config
    from livecc_tpu_torch.data.tokenizer import ByteTokenizer
    from livecc_tpu_torch.engine import LiveCCEngine
    from livecc_tpu_torch.models.qwen2_vl import init_params
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools.session import synth_frames

    cfg = tiny_config()
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    frames = synth_frames(10, 28, 28, seed=1)
    outs, launches = [], []
    for model in (cpu_model, copy.deepcopy(cpu_model).to("cuda")):
        eng = LiveCCEngine(model, cfg, ByteTokenizer(), cache_len=512, cache_dtype=torch.float32,
                           quantize_weights=True)
        before = build.launch_counts["w8a16_gemm"]
        outs.append(eng.live_cc_once_for_evaluation("describe", frames, max_new_tokens=16))
        launches.append(build.launch_counts["w8a16_gemm"] - before)
    log(f"  tiny w8 cpu: {outs[0]}")
    log(f"  tiny w8 gpu: {outs[1]}; {launches[1]} K5 launches")
    if len(outs[0]) != 3 or outs[0] != outs[1] or launches != [0, launches[1]] or not launches[1]:
        raise AssertionError(f"tiny w8: CPU and GPU engines disagree, or K5 launches {launches}")


@contextlib.contextmanager
def decoding(plain: bool, record: list):
    """Every decode of the engine and the pool goes through
    ``decode_chunk`` (the card's captured graphs) or, with ``plain``, the
    eager plain loop ``decode_chunk_plain``, called by name; each call's
    tokens and counts of generated tokens are appended to ``record``. With
    ``plain`` each entry also holds, for every selection of the call, the
    step index and the top ``TOP_K`` ids and values of the adjusted logits
    (``near_ties`` reads them); else None."""
    import torch

    from livecc_tpu_torch.engine import generation, streaming
    from livecc_tpu_torch.serve import scheduler

    fn = generation.decode_chunk_plain if plain else generation.decode_chunk
    adjust, tops = generation.adjust_logits, []

    def adjust_top(logits, counts, gen, step_index):
        out = adjust(logits, counts, gen, step_index)
        top = out.topk(TOP_K, dim=-1)
        step = torch.as_tensor(step_index, device=out.device).expand(out.shape[0])
        tops.append((step.to("cpu", copy=True), top.indices.cpu(), top.values.cpu()))
        return out

    def recorded(*args, **kw):
        tops.clear()
        out = fn(*args, **kw)
        record.append((out[0].clone(), out[1].clone(), list(tops) if plain else None))
        return out

    saved = streaming.decode_chunk, scheduler.decode_chunk, generation.adjust_logits
    streaming.decode_chunk = scheduler.decode_chunk = recorded
    if plain:
        generation.adjust_logits = adjust_top
    try:
        yield
    finally:
        streaming.decode_chunk, scheduler.decode_chunk, generation.adjust_logits = saved


def near_ties(label: str, spec: list, plain: list, stream_of) -> None:
    """Greedy lookahead decoding against plain decoding of the same session,
    both in bf16 on the card: token for token, except where a stream's two
    runs first part, which must be a near-tie. The window forwards 9 rows
    where a decode step forwards 1, and attends through K1 where the step
    uses K2, so the two round the same activations differently (on an int8
    cache a value on a rounding edge also takes the neighbouring code): a
    stream may part where the plain run's best two logits lie closer than
    that. There the lookahead's token must be among the plain run's top
    ``TOP_K`` at that step, its logit at most ``TIE_ULPS`` bf16 steps (2^-7
    relative each) below the best. A stream that parted is not compared
    further (its history differs). ``plain`` is the eager plain loop's
    record (with the logits' tops), ``stream_of(decode, row)`` names the
    stream a decode's row belongs to."""
    parted, rows, same = {}, 0, 0
    for d, ((ts, ns, _), (tp, np_, tops)) in enumerate(zip(spec, plain)):
        for r in range(tp.shape[0]):
            stream = stream_of(d, r)
            if stream in parted:
                continue
            rows += 1
            a, b = tp[r, :int(np_[r])].tolist(), ts[r, :int(ns[r])].tolist()
            if a == b:
                same += 1
                continue
            p = next(i for i in range(min(len(a), len(b))) if a[i] != b[i])
            # the last selection at position p decided the plain run's token
            step, ids, values = next(t for t in reversed(tops) if int(t[0][r]) == p)
            ids, values = ids[r].tolist(), values[r].tolist()
            limit = TIE_ULPS * 2 ** -7 * abs(values[0])
            below = values[0] - values[ids.index(b[p])] if b[p] in ids else float("inf")
            parted[stream] = (d, r, p, a[p], b[p], values[0] - values[1], below)
            log(f"  {label}: decode {d} row {r} parts at token {p}: plain {a[p]}, lookahead {b[p]} "
                f"(plain's top two {values[0] - values[1]:.4f} apart; the lookahead's token "
                f"{below:.4f} below the best, limit {limit:.4f})")
            if not below <= limit:
                raise AssertionError(f"{label}: decode {d} row {r} token {p}: the lookahead's "
                                     f"{b[p]} is {below} below the plain run's best, past "
                                     f"{limit}: not a near-tie")
    log(f"  {label}: lookahead and plain decoding token-identical in {same} of {rows} decoded "
        f"rows; {len(parted)} streams parted at a near-tie")
    if len(spec) != len(plain):
        raise AssertionError(f"{label}: {len(spec)} lookahead decodes against {len(plain)} plain")


def same_tokens(label: str, graph: list, plain: list,
                what: str = "graph replay and the eager plain loop") -> None:
    """Two runs (``what``) emitted the same tokens in every decode."""
    import torch

    if len(graph) != len(plain) or not all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(graph, plain)):
        raise AssertionError(f"{label}: {what} emit different tokens")
    n = sum(int(x[1].sum()) for x in graph)
    log(f"  {label}: {what} token-identical over {len(graph)} decodes ({n} tokens)")


def run_twice(label: str, model, counts_of, session, walls_of,
              profiled=None) -> tuple[dict, object, list, dict]:
    """``session(plain)`` through the graphs and through the eager plain
    loop, each from a fresh state on the same model: launch counts (reset
    just before, read just after), walls (the run's, and ``walls_of`` its
    result's chunks or ticks) and captures of each run; then the graphs'
    once more under the profiler for the device's busy time, or, given
    ``profiled``, its (wall, busy) of a shorter profiled run. Fails
    unless the two emit the same tokens and launch the same kernels as
    often. Returns the graph run's counts, the session's result, the
    eager plain loop's record (the same tokens, and the logits' tops) and
    the profiled run's {"wall", "busy"}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from livecc_tpu_torch.engine.graphs import graphs_for
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools.profile_stream import busy_seconds

    graphs = graphs_for(model, model.cfg)
    runs = {}
    for plain in (False, True):
        record: list = []
        graphs.reset_stats()
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        with decoding(plain, record):
            result = session(plain)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counts_of()
        stats = graphs.stats()
        name = "eager plain loop" if plain else "graph replay"
        log(f"  {label} {name}: wall {wall:.3f} s ({walls_of(result)}), {stats['captures']} "
            f"captures in {stats['capture_seconds']:.3f} s, {stats['replays']} replays, "
            f"{stats['host_reads']} host reads; launches {counts}")
        runs[plain] = (counts, record, result)
    same_tokens(label, runs[False][1], runs[True][1])
    if runs[False][0] != runs[True][0]:
        raise AssertionError(f"{label}: launch counts differ, graph replay {runs[False][0]} "
                             f"against the eager plain loop {runs[True][0]}")
    log(f"  {label}: launch counts equal, replays counted")
    if profiled is None:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            session(False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, what = busy_seconds(prof), "graph replay (profiled)"
    else:
        (wall, busy), what = profiled(), "one steady tick of a fresh graph run (profiled)"
    log(f"  {label} {what}: wall {wall:.3f} s, device busy {busy:.3f} s, idle share "
        f"{1 - busy / wall:.3f}")
    return runs[False][0], runs[False][2], runs[True][1], {"wall": wall, "busy": busy}


@contextlib.contextmanager
def lookahead(plain: bool, record: list):
    """Every lookahead decode of the engine and the pool goes through
    ``decode_chunk_lookahead`` (the card's captured lookahead step) or, with
    ``plain``, the eager loop ``decode_chunk_lookahead_plain``, called by
    name; each call's tokens and counts of generated tokens are appended to
    ``record``."""
    from livecc_tpu_torch.engine import speculative, streaming
    from livecc_tpu_torch.serve import scheduler

    fn = (speculative.decode_chunk_lookahead_plain if plain
          else speculative.decode_chunk_lookahead)

    def recorded(*args, **kw):
        out = fn(*args, **kw)
        record.append((out[0].clone(), out[1].clone(), None))
        return out

    saved = streaming.decode_chunk_lookahead, scheduler.decode_chunk_lookahead
    streaming.decode_chunk_lookahead = scheduler.decode_chunk_lookahead = recorded
    try:
        yield
    finally:
        streaming.decode_chunk_lookahead, scheduler.decode_chunk_lookahead = saved


def run_spec_twice(label: str, model, session, walls_of, plain_record: list,
                   streams) -> tuple:
    """``session()`` with lookahead decoding through the captured lookahead
    step and through the eager lookahead loop, each from a fresh state on
    the same model, launch counts reset just before and read just after.
    Fails unless the two emit the same tokens, launch every kernel as often
    (replays counted), the graphs read one stop flag per window (at most
    one a window or capture, at least that less one a decode), and the
    tokens are the plain decoding's of the same session (``plain_record``)
    up to near-ties (``near_ties``; ``streams(result)`` gives its
    ``stream_of``). Returns the graph run's counts and result."""
    import torch

    from livecc_tpu_torch.engine.graphs import graphs_for
    from livecc_tpu_torch.ops import build

    graphs = graphs_for(model, model.cfg)
    runs = {}
    for plain in (False, True):
        record: list = []
        graphs.reset_stats()
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        with lookahead(plain, record):
            result = session()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(build.launch_counts)
        st = graphs.stats()
        name = "eager lookahead loop" if plain else "lookahead graphs"
        log(f"  {label} {name}: wall {wall:.3f} s ({walls_of(result)}), {st['captures']} captures "
            f"in {st['capture_seconds']:.3f} s, {st['windows']} window replays, {st['replays']} "
            f"decode replays, {st['host_reads']} host reads; launches {counts}")
        runs[plain] = (counts, record, result, st)
    same_tokens(label, runs[False][1], runs[True][1],
                "the lookahead graphs and the eager lookahead loop")
    if runs[False][0] != runs[True][0]:
        raise AssertionError(f"{label}: launch counts differ, lookahead graphs {runs[False][0]} "
                             f"against the eager lookahead loop {runs[True][0]}")
    st, decodes = runs[False][3], len(runs[False][1])
    steps = st["windows"] + st["captures"]
    if not (st["windows"] > 0 and st["replays"] == 0
            and steps - decodes <= st["host_reads"] <= steps):
        raise AssertionError(f"{label}: not one captured lookahead step replayed with one host "
                             f"read each over {decodes} decodes: {st}")
    log(f"  {label}: launch counts equal, replays counted; {st['host_reads']} host reads for "
        f"{steps} lookahead steps over {decodes} decodes")
    near_ties(label, runs[False][1], plain_record, streams(runs[False][2]))
    return runs[False][0], runs[False][2]


def step_replay_ms(model, cache, state_type) -> float:
    """Device time of one replay of the captured step of ``model`` over
    ``cache`` whose state is a ``state_type``, after its chunk ended (no row
    advances, so every replay does the same work at the same depth):
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


def phase_main(cfg, model) -> tuple[dict, list, dict]:
    """The 7B single stream (``single_stream``) on the bf16 model."""
    return single_stream("main", cfg, model, MAIN_KERNELS)


def single_stream(label: str, cfg, model, kernels) -> tuple[dict, list, dict]:
    """The 7B single stream, 5 chunks, through the decode graphs and through
    the eager plain loop (``run_twice``); then the device time of one replay
    of its decode step at the session's last depth (``replay_ms``). Fails
    unless every kernel of ``kernels`` launched. Returns the graph run's
    launch counts, the eager plain loop's record and {"step_ms": that time,
    "wall", "busy": the profiled session's, "tokens": the graph run's
    tokens of each decode}."""
    import torch

    from livecc_tpu_torch.engine.generation import DecodeState
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import session

    frames = session.main_frames()

    def run(plain):
        eng = session.new_engine(cfg, model)
        state = eng.new_stream()
        return eng, state, session.run_session(eng, frames, state=state)

    torch.cuda.reset_peak_memory_stats()
    chunk_walls = lambda r: "chunks " + ", ".join(f"{c.seconds * 1e3:.1f}"
                                                   for c in r[0].chunk_log) + " ms"
    counts, (eng, state, out), record, prof = run_twice(
        label, model, lambda: dict(build.launch_counts), run, chunk_walls)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for (t_a, t_b, text), rec in zip(out, eng.chunk_log):
        log(f"  chunk {t_a:4.1f}-{t_b:4.1f}s  wall {rec.seconds * 1e3:9.2f} ms  prompt "
            f"{rec.prompt_tokens:4d} tok  generated {rec.generated_tokens:2d} tok  {text!r}")
    log(f"  {label} path: {len(out)} chunks, peak memory {peak:.2f} GiB, launches {counts}")
    if len(out) != 5 or len(eng.chunk_log) != 5:
        raise AssertionError(f"expected 5 chunks, got {len(out)}")
    if not all(rec.generated_tokens > 0 for rec in eng.chunk_log):
        raise AssertionError("a chunk generated no token")
    if state.logits is None or state.logits.shape != (1, cfg.text.vocab_size) or not bool(
            torch.isfinite(state.logits).all()):
        raise AssertionError("last prefill logits missing, misshapen or non-finite")
    missing = [name for name in kernels if counts.get(name, 0) <= 0]
    if missing:
        raise AssertionError(f"the {label} path never launched {missing}")
    step_ms = step_replay_ms(model, state.cache, DecodeState)
    log(f"  decode step replay at depth {int(state.cache.offset[0])}, B=1: {step_ms:.3f} ms "
        f"device time")
    return counts, record, dict(prof, step_ms=step_ms, tokens=[t for t, *_ in record])


def phase_pool(cfg, model) -> tuple[dict, list, dict]:
    """The 7B serving pool (``pool_phase``) on the bf16 model."""
    return pool_phase("pool", cfg, model, POOL_KERNELS)


def profiled_pool_tick(cfg, model) -> tuple[float, float]:
    """(wall, device busy) of the last steady tick of a fresh pool run
    (``session.run_pool`` after a warmup) under the profiler: 8 steady
    chunks at B = 8, the tick the pool serves at the 1 Hz cadence."""
    from torch.profiler import ProfilerActivity, profile

    from livecc_tpu_torch.tools import session
    from livecc_tpu_torch.tools.profile_stream import busy_seconds

    server = session.pool_server(cfg, model)
    server.warmup([(session.HEIGHT, session.WIDTH)])
    profs = []

    def around(tick):
        if tick < session.POOL_STEADY_TICKS:
            return contextlib.nullcontext()
        profs.append(profile(activities=[ProfilerActivity.CUDA]))
        return profs[-1]

    _, walls = session.run_pool(server, around_tick=around)
    return walls[-1], busy_seconds(profs[0])


def pool_phase(label: str, cfg, model, kernels) -> tuple[dict, list, dict]:
    """The 7B in the serving pool: 8 streams, int8 KV, 4 ticks, through the
    decode graphs and through the eager plain loop (``run_twice``; busy time
    from one steady tick, ``profiled_pool_tick``); then the device time of
    one replay of the pool's decode step at its last depths. Fails unless
    every kernel of ``kernels`` launched. Returns the graph run's launch
    counts, the eager plain loop's record and {"step_ms": that time,
    "ticks": the graph run's tick walls, "wall", "busy": the profiled
    tick's}."""
    import torch

    from livecc_tpu_torch.engine.generation import DecodeState
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import session

    def run(plain):
        server = session.pool_server(cfg, model)
        t0 = time.perf_counter()
        server.warmup([(session.HEIGHT, session.WIDTH)])
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        server.engine.metrics.reset()
        build.reset_launch_counts()           # the served ticks only
        out, walls = session.run_pool(server)
        return server, warm, out, walls

    torch.cuda.reset_peak_memory_stats()
    tick_walls = lambda r: (f"warmup {r[1] * 1e3:.1f} ms, ticks "
                            + ", ".join(f"{w * 1e3:.1f}" for w in r[3]) + " ms")
    counts, (server, warm, out, walls), record, prof = run_twice(
        label, model, lambda: dict(build.launch_counts), run, tick_walls,
        lambda: profiled_pool_tick(cfg, model))
    peak = torch.cuda.max_memory_allocated() / 2**30
    pool = server.pool_caches
    kv_gb = (pool.k.nbytes + pool.v.nbytes) / 1e9
    scale_mb = (pool.k_scale.nbytes + pool.v_scale.nbytes) / 1e6
    log(f"  warmup (init path + one pool step on the scratch pool, captured there): "
        f"{warm:.2f} s")
    for i, wall in enumerate(walls):
        kind = f"{len(out)} init chunks, solo + adoption" if i == 0 else f"pool step, B={len(out)}"
        log(f"  tick {i}: wall {wall * 1e3:9.2f} ms  ({kind})")
    m = server.engine.metrics.summary()
    sub = m["chunk_submit_to_text"]
    log(f"  chunk_submit_to_text p50 {sub['p50'] * 1e3:.1f} ms  p99 {sub['p99'] * 1e3:.1f} ms "
        f"(n={sub['n']}); chunk_e2e_latency p50 {m['chunk_e2e_latency']['p50'] * 1e3:.1f} ms")
    log(f"  pool KV {kv_gb:.3f} GB int8 + {scale_mb:.1f} MB scales; peak memory {peak:.2f} GiB; "
        f"launches {counts}")
    for sid, rows in out.items():
        log(f"  stream {sid} slot {server._streams[sid].slot}: {[text for _, text in rows]!r}"[:200])
    if len(out) != session.POOL_STREAMS or any(
            len(rows) != 1 + session.POOL_STEADY_TICKS for rows in out.values()):
        raise AssertionError(f"{label}: expected {1 + session.POOL_STEADY_TICKS} chunks of text "
                             f"for each of {session.POOL_STREAMS} streams")
    if not bool((pool.offset > 0).all()) or not bool(
            torch.isfinite(pool.k_scale.float()).all() and torch.isfinite(pool.v_scale.float()).all()):
        raise AssertionError(f"{label}: a slot never advanced, or non-finite scales")
    missing = [name for name in kernels if counts.get(name, 0) <= 0]
    if missing:
        raise AssertionError(f"the {label} path never launched {missing}")
    step_ms = step_replay_ms(model, pool, DecodeState)
    log(f"  decode step replay at depths {pool.offset.tolist()}, B=8: {step_ms:.3f} ms device time")
    return counts, record, dict(prof, step_ms=step_ms, ticks=walls)


def pool_streams(server):
    """``stream_of(decode, row)`` of a ``session.run_pool`` run after a warmup:
    decodes 0 and 1 are the warmup's (its solo init chunk, its pool step),
    then one solo init decode per stream in stream order, then the ticks,
    whose row r is the stream in slot r."""
    sids = sorted(server._streams)
    in_slot = {server._streams[sid].slot: sid for sid in sids}

    def stream_of(d, r):
        if d < 2:
            return ("warmup", d, r)
        return sids[d - 2] if d < 2 + len(sids) else in_slot.get(r, ("idle", r))

    return stream_of


class AdversarialDraft:
    """Drafts that always miss: ``k`` copies of one id the session never emits."""

    def __init__(self, k: int, token: int):
        self.k, self.token = k, token

    def propose(self, ids, pad_token_id=0):
        return [self.token] * self.k


def phase_main_spec(cfg, model, plain_record: list, decode_ms: float) -> tuple[dict, dict]:
    """The 7B single stream of ``main`` with speculative decoding
    (``session.SPEC``: fused lookahead, 8 drafts, 3-grams, controller off),
    through the captured lookahead step and through the eager lookahead
    loop (``run_spec_twice``): the tokens must be the plain decoding's up to
    near-ties.
    Then one lookahead-step replay at the session's last depth against
    ``main``'s decode step there (the window premium at B = 1), and the
    host-drafted loop over the first two chunks with drafts that always
    miss (the worst case; its tokens held to the plain decoding's the same
    way). Returns the lookahead graphs' launch counts and the worst case's."""
    import torch

    from livecc_tpu_torch.engine import SpecConfig, streaming
    from livecc_tpu_torch.engine.speculative import LookaheadState
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import session

    frames = session.main_frames()

    def run():
        eng = session.new_engine(cfg, model, session.SPEC)
        state = eng.new_stream()
        return eng, state, session.run_session(eng, frames, state=state)

    def chunks(r):
        return ", ".join(f"{c.seconds * 1e3:.1f} ms / {c.windows} windows / {c.generated_tokens} "
                         f"tokens" for c in r[0].chunk_log)

    counts, (eng, state, _) = run_spec_twice("main_spec", model, run, chunks, plain_record,
                                             lambda _: lambda d, r: 0)
    windows = sum(c.windows for c in eng.chunk_log)
    tokens = sum(c.generated_tokens for c in eng.chunk_log)
    log(f"  main_spec: {windows} windows for {tokens} tokens ({tokens / windows:.2f} tokens a "
        f"window, 1 seed token a chunk included)")
    missing = [name for name in MAIN_SPEC_KERNELS if counts.get(name, 0) <= 0]
    if missing:
        raise AssertionError(f"the main_spec path never launched {missing}")
    window_ms = step_replay_ms(model, state.cache, LookaheadState)
    log(f"  window premium, B=1: lookahead step replay {window_ms:.3f} ms against decode step "
        f"replay {decode_ms:.3f} ms at depth {int(state.cache.offset[0])}: "
        f"{window_ms / decode_ms:.3f}x")
    del eng, state
    # the worst case: host-drafted windows whose drafts never match
    emitted = {int(t) for tokens, *_ in plain_record for t in tokens.flatten()}
    miss = min(set(range(cfg.text.vocab_size)) - emitted)
    eng = session.new_engine(cfg, model, SpecConfig(k_draft=session.SPEC.k_draft, fused=False))
    eng.spec_draft_source = AdversarialDraft(session.SPEC.k_draft, miss)
    n_frames = session.INIT_FRAMES + session.STEADY_FRAMES
    host_loop, record = streaming.speculative_decode_chunk, []

    def recorded(*args, **kw):
        generated, windows = host_loop(*args, **kw)
        tokens = torch.full((1, session.NEW_TOKENS), cfg.pad_token_id, dtype=torch.int32)
        tokens[0, :len(generated)] = torch.tensor(generated, dtype=torch.int32)
        record.append((tokens, torch.tensor([len(generated)]), None))
        return generated, windows

    torch.cuda.synchronize()
    build.reset_launch_counts()
    streaming.speculative_decode_chunk = recorded
    try:
        t0 = time.perf_counter()
        session.run_session(eng, frames[:n_frames])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        streaming.speculative_decode_chunk = host_loop
    adv_counts = dict(build.launch_counts)
    log(f"  worst case (host-drafted, drafts of id {miss} always miss): wall {wall:.3f} s, chunks "
        + ", ".join(f"{c.seconds * 1e3:.1f} ms / {c.windows} windows / {c.generated_tokens} tokens"
                    for c in eng.chunk_log) + f"; launches {adv_counts}")
    near_ties("worst case", record, plain_record[:len(record)], lambda d, r: 0)
    if len(record) != 2 or any(c.windows != c.generated_tokens for c in eng.chunk_log):
        raise AssertionError("worst case: not two chunks, or a draft was accepted")
    return counts, adv_counts


def phase_pool_spec(cfg, model, plain_record: list, decode_ms: float) -> dict:
    """The pool of ``pool`` with lookahead decoding (``session.SPEC``)
    through the captured lookahead step and through the eager lookahead
    loop (``run_spec_twice``): every decode's tokens must be the plain
    decode graphs'. Then one lookahead-step replay at the pool's last
    depths against ``pool``'s decode step (the window premium at B = 8).
    Returns the lookahead graphs' launch counts."""
    import torch

    from livecc_tpu_torch.engine.speculative import LookaheadState
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import session

    def run():
        server = session.pool_server(cfg, model, spec=session.SPEC)
        t0 = time.perf_counter()
        server.warmup([(session.HEIGHT, session.WIDTH)])
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        server.engine.metrics.reset()
        build.reset_launch_counts()           # the served ticks only
        out, walls = session.run_pool(server)
        return server, warm, out, walls

    def ticks(r):
        tpw = r[0].engine.metrics.summary("spec_tokens_per_window")
        return (f"warmup {r[1] * 1e3:.1f} ms, ticks " + ", ".join(f"{w * 1e3:.1f}" for w in r[3])
                + f" ms; tokens a window per stream in the steady ticks: mean {tpw.get('mean')}"
                  f" (n={tpw.get('n')})")

    counts, (server, warm, out, walls) = run_spec_twice("pool_spec", model, run, ticks,
                                                        plain_record, lambda r: pool_streams(r[0]))
    if len(out) != session.POOL_STREAMS or any(
            len(rows) != 1 + session.POOL_STEADY_TICKS for rows in out.values()):
        raise AssertionError("pool_spec: a stream is missing chunks of text")
    missing = [name for name in POOL_SPEC_KERNELS if counts.get(name, 0) <= 0]
    if missing:
        raise AssertionError(f"the pool_spec path never launched {missing}")
    pool = server.pool_caches
    window_ms = step_replay_ms(model, pool, LookaheadState)
    log(f"  window premium, B=8: lookahead step replay {window_ms:.3f} ms against decode step "
        f"replay {decode_ms:.3f} ms at depths {pool.offset.tolist()}: "
        f"{window_ms / decode_ms:.3f}x")
    return counts


def phase_main_w8(cfg, model, main_record: list, main: dict, init: dict) -> tuple[dict, dict]:
    """``main``'s single stream on the 7B with int8 weights (``init``: its
    build, beside the bf16 model's memory) and a bf16 KV cache, through the
    decode graphs and the eager plain loop (``single_stream``: identical
    tokens, equal launch counts, K5 launched). Every quantized site holds a
    quantized module. Prints session wall, busy time and one decode-step
    replay at B = 1 beside ``main``'s, and the share of greedy tokens equal
    to main's bf16 run (information only: the weights differ). Then one
    lookahead session (``session.SPEC``) through the lookahead graphs and
    the eager lookahead loop (``run_spec_twice``), so K5's M = 9 form runs in
    the window graph. Returns the graph runs' launch counts (plain,
    lookahead)."""
    from livecc_tpu_torch.ops.quant import QuantEmbedding, QuantLinear, quantized_sites
    from livecc_tpu_torch.tools import session

    plain = [f"{type(p).__name__}.{a}" for p, a in quantized_sites(model)
             if not isinstance(getattr(p, a), (QuantLinear, QuantEmbedding))]
    if plain:
        raise AssertionError(f"main_w8: unquantized modules at quantized sites: {plain[:8]}")
    log(f"  model: {init['gib']:.2f} GiB of weights on the card ({init['bytes_gib']:.2f} GiB "
        f"of parameters and buffers; bf16: {init['bf16_gib']:.2f} GiB), "
        f"{len(quantized_sites(model))} quantized modules, built and quantized in "
        f"{init['seconds']:.1f} s with a peak {init['peak_gib']:.2f} GiB above what was held")
    counts, record, w8 = single_stream("main_w8", cfg, model, MAIN_W8_KERNELS)
    log(f"  main_w8 against main (bf16 weights): session wall {w8['wall']:.3f} against "
        f"{main['wall']:.3f} s, device busy {w8['busy']:.3f} against {main['busy']:.3f} s "
        f"(profiled runs); decode step replay B=1 {w8['step_ms']:.3f} against "
        f"{main['step_ms']:.3f} ms ({w8['step_ms'] / main['step_ms']:.3f}x)")
    same = total = 0
    for a, b in zip(w8["tokens"], main["tokens"]):
        same += int((a == b).sum())
        total += a.numel()
    log(f"  main_w8: {same} of {total} greedy token slots equal to main's bf16 run "
        f"({same / total:.3f}; information, not a check: the weights differ)")
    frames = session.main_frames()

    def run():
        eng = session.new_engine(cfg, model, session.SPEC)
        state = eng.new_stream()
        return eng, state, session.run_session(eng, frames, state=state)

    def chunks(r):
        return ", ".join(f"{c.seconds * 1e3:.1f} ms / {c.windows} windows / {c.generated_tokens} "
                         f"tokens" for c in r[0].chunk_log)

    spec_counts, _ = run_spec_twice("main_w8_spec", model, run, chunks, record,
                                    lambda _: lambda d, r: 0)
    missing = [name for name in MAIN_W8_SPEC_KERNELS if spec_counts.get(name, 0) <= 0]
    if missing:
        raise AssertionError(f"the main_w8 lookahead path never launched {missing}")
    return counts, spec_counts


def phase_pool_w8(cfg, model, pool: dict) -> dict:
    """JAX's TPU serving configuration: ``pool``'s 8 streams on the 7B with
    int8 weights and the int8 KV cache, through the decode graphs and the
    eager plain loop (``pool_phase``: identical tokens, K5 launched). Prints
    the steady ticks, the profiled tick's busy time and one B = 8 decode-step
    replay beside ``pool``'s. Returns the graph run's launch counts."""
    counts, _, w8 = pool_phase("pool_w8", cfg, model, POOL_W8_KERNELS)
    ticks = lambda d: ", ".join(f"{t * 1e3:.1f}" for t in d["ticks"][1:])
    log(f"  pool_w8 against pool (bf16 weights): steady ticks {ticks(w8)} against {ticks(pool)} "
        f"ms; profiled steady tick wall {w8['wall'] * 1e3:.1f} against {pool['wall'] * 1e3:.1f} "
        f"ms, device busy {w8['busy'] * 1e3:.1f} against {pool['busy'] * 1e3:.1f} ms; decode "
        f"step replay B=8 {w8['step_ms']:.3f} against {pool['step_ms']:.3f} ms "
        f"({w8['step_ms'] / pool['step_ms']:.3f}x)")
    return counts


class FramesVideo:
    """``VideoReader``'s API over frames in memory (``LiveCC``'s and
    ``MCQPredictor``'s ``video_loader`` where no FFmpeg is installed to
    decode a clip): frame i at ``i / fps`` s. It reports ``source_hw`` (by
    default the frames' own size) as the video's frame size and serves the
    frames at their own size only: a caller asking for any other size
    raises."""

    def __init__(self, frames, fps: float, source_hw=None):
        import numpy as np

        self.frames, self.avg_fps = frames, float(fps)
        self.frame_size = tuple(source_hw or frames.shape[1:3])
        self.pts_seconds = np.arange(len(frames)) / self.avg_fps

    def __len__(self) -> int:
        return len(self.frames)

    def get_batch(self, indices, out_hw=None):
        import numpy as np

        own = tuple(self.frames.shape[1:3])
        if tuple(out_hw or self.frame_size) != own:
            raise ValueError(f"FramesVideo serves {own} frames, asked for {out_hw}")
        return self.frames[np.asarray(indices)]


def rss_gb() -> float:
    """The process's resident set (``/proc/self/status`` VmRSS) in GB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no VmRSS in /proc/self/status")


@contextlib.contextmanager
def rss_peak(every_s: float = 0.005):
    """Yields a dict whose "peak" is, on exit, the largest VmRSS (GB) read
    every ``every_s`` s by a sampling thread while the block ran (not every
    kernel keeps VmHWM, the peak)."""
    import threading

    out, stop = {"peak": rss_gb()}, threading.Event()

    def sample():
        while not stop.wait(every_s):
            out["peak"] = max(out["peak"], rss_gb())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join()
        out["peak"] = max(out["peak"], rss_gb())


def phase_checkpoint_live(cfg, models: list) -> dict:
    """The front door on the 7B that ``main`` ran (``models``' only entry,
    popped and freed here): written as an HF checkpoint (bf16 safetensors
    shards of ~5 GB with an index, >=4.52 names, config.json from
    ``tests/fixtures/qwen2_vl_7b_config.json``) under ``build/``, loaded
    back by ``load_checkpoint`` (bit-equal, load seconds, peak device and
    host memory), then a 10 s clip at 10 fps of 308x560 frames through the
    CLI's engine on the checkpoint: ``demo.cli.main`` over the clip encoded
    by the port's decoder where the card has the FFmpeg development
    libraries (pkg-config), else ``LiveCC`` over the frames through a
    ``video_loader`` (``FramesVideo``) with the CLI's engine and decoding
    settings. Its greedy tokens must be those of the same frames through
    ``session.new_engine`` on the source model. Returns the CLI run's launch
    counts."""
    import shutil
    import tempfile

    import torch

    from livecc_tpu_torch.data.tokenizer import ByteTokenizer
    from livecc_tpu_torch.demo import cli
    from livecc_tpu_torch.engine.live import LiveCC
    from livecc_tpu_torch.models.qwen2_vl.convert import load_checkpoint
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import session
    from livecc_tpu_torch.tools.checkpoint import save_checkpoint
    from livecc_tpu_torch.vision_io import video_reader

    model = models.pop()
    ffmpeg = video_reader.has_ffmpeg()
    log(f"  FFmpeg development libraries (pkg-config): "
        + ("found: demo.cli.main runs on a clip the port's decoder encodes" if ffmpeg else
           "absent: the port's decoder cannot build here, so LiveCC reads the frames through "
           "a video_loader and demo.cli.main is not run"))
    frames = session.synth_frames(CLIP_SECONDS * CLIP_FPS, session.HEIGHT, session.WIDTH,
                                  seed=session.SEED)
    tokenizer = ByteTokenizer.for_config(cfg)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    parent = os.path.join(ROOT, "build")
    os.makedirs(parent, exist_ok=True)
    free = shutil.disk_usage(parent).free
    log(f"  disk free at {parent}: {free / 1e9:.1f} GB; the checkpoint takes {nbytes / 1e9:.2f} GB")
    if free < nbytes + 2e9:
        raise AssertionError(f"checkpoint_live: {free / 1e9:.1f} GB free, need "
                             f"{(nbytes + 2e9) / 1e9:.1f} GB")
    work = tempfile.mkdtemp(prefix="checkpoint_live_", dir=parent)
    try:
        path = os.path.join(work, "qwen2-vl-7b-random")
        t0 = time.perf_counter()
        files = save_checkpoint(model, cfg, path,
                                os.path.join(ROOT, "tests", "fixtures", "qwen2_vl_7b_config.json"))
        log(f"  wrote {len(files)} shards, {nbytes / 1e9:.2f} GB bf16, in "
            f"{time.perf_counter() - t0:.1f} s")
        if ffmpeg:
            clip = os.path.join(work, "clip.mp4")
            video_reader.encode_test_video(clip, frames, fps=CLIP_FPS)
            video, loader = clip, None
        else:
            video, loader = "frames", (lambda _: FramesVideo(frames, CLIP_FPS))

        def commentate(engine, record):
            live = LiveCC(engine) if loader is None else LiveCC(engine, video_loader=loader)
            with decoding(False, record):
                return cli.commentate(live, video, CLIP_SECONDS, QUERY,
                                      cli.generation_params(engine))

        reference: list = []
        ref_out = commentate(session.new_engine(cfg, model), reference)
        torch.cuda.synchronize()

        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        rss = rss_gb()
        with rss_peak() as host:
            t0 = time.perf_counter()
            cfg2, loaded = load_checkpoint(path, "cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        dev_peak = torch.cuda.max_memory_allocated() - before
        source = dict(model.named_parameters())
        if cfg2.text != cfg.text or cfg2.vision != cfg.vision or not all(
                p.dtype == source[n].dtype and torch.equal(p, source[n])
                for n, p in loaded.named_parameters()) or len(source) != len(
                list(loaded.parameters())):
            raise AssertionError("checkpoint_live: the loaded 7B differs from its source")
        log(f"  load_checkpoint: {len(source)} tensors, bit-equal to the source 7B; "
            f"{load_s:.2f} s; device memory peak {dev_peak / 2**30:.2f} GiB above the "
            f"{before / 2**30:.2f} GiB held before; host RSS {rss:.2f} GB before, peak "
            f"{host['peak']:.2f} GB during the load (VmRSS sampled every 5 ms; "
            f"{nbytes / 1e9:.2f} GB of weights)")
        del loaded, source, model
        gc.collect()
        torch.cuda.empty_cache()

        record: list = []
        build.reset_launch_counts()
        t0 = time.perf_counter()
        if ffmpeg:
            out_json = os.path.join(work, "out.json")
            with decoding(False, record):
                result = cli.main(["--video", clip, "--model", path, "--seconds",
                                   str(CLIP_SECONDS), "--query", QUERY, "--output", out_json],
                                  tokenizer=tokenizer)
            out = result["commentaries"]
            with open(out_json) as f:
                if json.load(f) != result:
                    raise AssertionError("checkpoint_live: the CLI's JSON is not its result")
            what = "demo.cli.main (engine build and checkpoint load included)"
        else:
            engine = cli.build_engine(path, tokenizer=tokenizer)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = commentate(engine, record)
            what = f"LiveCC on the CLI's engine (built, checkpoint loaded, in {build_s:.2f} s before)"
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(build.launch_counts)
        if not ffmpeg:
            del engine
        gc.collect()
        torch.cuda.empty_cache()
        # the same through the CLI's --quantize-weights: int8 weights, K5
        build.reset_launch_counts()
        t0 = time.perf_counter()
        if ffmpeg:
            with decoding(False, []):
                out_w8 = cli.main(["--video", clip, "--model", path, "--seconds",
                                   str(CLIP_SECONDS), "--query", QUERY, "--quantize-weights"],
                                  tokenizer=tokenizer)["commentaries"]
            what_w8 = "demo.cli.main --quantize-weights (engine build and load included)"
        else:
            engine = cli.build_engine(path, tokenizer=tokenizer, quantize_weights=True)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            out_w8 = commentate(engine, [])
            what_w8 = (f"LiveCC on the CLI's engine with --quantize-weights (built, loaded and "
                       f"quantized in {build_s:.2f} s before)")
            del engine
        torch.cuda.synchronize()
        wall_w8 = time.perf_counter() - t0
        counts_w8 = dict(build.launch_counts)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  live session over the {CLIP_SECONDS} s clip, {what}: {wall:.2f} s; "
        f"launches {counts}")
    for t_a, t_b, text in out:
        log(f"  [{t_a:4.1f}-{t_b:4.1f}s] {text!r}"[:160])
    same_tokens("checkpoint_live", record, reference,
                "the CLI's engine on the loaded checkpoint and the source model's engine")
    if out != ref_out:
        raise AssertionError("checkpoint_live: the commentary differs from the source model's")
    log(f"  live session over the {CLIP_SECONDS} s clip, {what_w8}: {wall_w8:.2f} s; "
        f"launches {counts_w8}")
    for t_a, t_b, text in out_w8:
        log(f"  w8 [{t_a:4.1f}-{t_b:4.1f}s] {text!r}"[:160])
    for label, result in (("checkpoint_live", out), ("checkpoint_live --quantize-weights",
                                                     out_w8)):
        spans = [(a, b) for a, b, _ in result]
        if spans[0] != (0.0, 3.0) or any(b0 != a1 for (_, a1), (b0, _) in zip(spans, spans[1:])) \
                or spans[-1][1] != CLIP_SECONDS or not all(text for *_, text in result):
            raise AssertionError(f"{label}: spans {spans} not contiguous from the 3 s init "
                                 f"window to {CLIP_SECONDS} s, or a chunk without text")
    for label, c, kernels in (("checkpoint_live", counts, MAIN_KERNELS),
                              ("checkpoint_live --quantize-weights", counts_w8, MAIN_W8_KERNELS)):
        missing = [name for name in kernels if c.get(name, 0) <= 0]
        if missing:
            raise AssertionError(f"the {label} path never launched {missing}")
    return counts, counts_w8


def eval_items(n_frames: int, hw, questions):
    """VideoMME rows over ``len(questions)`` synthetic clips of ``n_frames``
    uint8 frames of ``hw`` at ``EVAL_FPS`` (numpy seeds 20, 21, ...), and the
    clips by path."""
    from livecc_tpu_torch.tools import session

    clips, rows = {}, []
    for i, question in enumerate(questions):
        path = f"item{i}_{n_frames}x{hw[0]}x{hw[1]}.mp4"
        clips[path] = session.synth_frames(n_frames, *hw, seed=20 + i)
        rows.append({"video": path, "question": question, "options": list(EVAL_OPTIONS),
                     "answer": "A", "duration": "short", "domain": "Sports Competition",
                     "sub_category": "Football", "task_type": "Action Recognition",
                     "video_id": f"match{i}", "question_id": f"{i}-1"})
    return rows, clips


@contextlib.contextmanager
def attention_swapped(vit_fn=None, llm_fn=None, store=None):
    """While entered, the vision tower's K3 call and the text tower's K4
    call (``vision.vit_group_attention``, ``text.train_flash_attention``) go
    to ``vit_fn`` / ``llm_fn`` where given; with ``store``, each call's
    inputs are kept there ("vit": (q, k, v), "llm": (q, k, v, mask)), the
    last call's replacing the one before."""
    from livecc_tpu_torch.models.qwen2_vl import text, vision

    vit, llm = vision.vit_group_attention, text.train_flash_attention
    vit_fn, llm_fn = vit_fn or vit, llm_fn or llm

    def vit_call(q, k, v):
        if store is not None:
            store["vit"] = (q, k, v)
        return vit_fn(q, k, v)

    def llm_call(q, k, v, attention_mask=None):
        if store is not None:
            store["llm"] = (q, k, v, attention_mask)
        return llm_fn(q, k, v, attention_mask)

    vision.vit_group_attention, text.train_flash_attention = vit_call, llm_call
    try:
        yield store
    finally:
        vision.vit_group_attention, text.train_flash_attention = vit, llm


def timed_calls(obj, name: str, record: list) -> None:
    """Replace ``obj.name`` by a wrapper that appends (synchronized wall
    seconds, result) of every call to ``record``."""
    import torch

    fn = getattr(obj, name)

    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        record.append((time.perf_counter() - t0, out))
        return out

    setattr(obj, name, run)


def same_letters(label: str, a, b) -> None:
    """Letters of two runs of the same items, fp32 [B, L] logits each (or
    lists of them): equal, or where they part, ``b``'s letter within
    ``TIE_ULPS`` bf16 steps of ``a``'s best logit (``near_ties``' limit)."""
    import torch

    a, b = torch.cat(list(a)), torch.cat(list(b))
    for i, (x, y) in enumerate(zip(a.tolist(), b.tolist())):
        ia, ib = max(range(len(x)), key=x.__getitem__), max(range(len(y)), key=y.__getitem__)
        top2 = sorted(x)[-2:]
        if ia != ib:
            limit = TIE_ULPS * 2 ** -7 * abs(x[ia])
            log(f"  {label}: item {i} parts: {EVAL_OPTIONS[ia][0]} against "
                f"{EVAL_OPTIONS[ib][0]} ({x[ia] - x[ib]:.4f} apart, limit {limit:.4f})")
            if not x[ia] - x[ib] <= limit:
                raise AssertionError(f"{label}: item {i}: letters {ia} and {ib} differ past a "
                                     f"near-tie ({x[ia] - x[ib]} > {limit})")
        log(f"  {label}: item {i}: letter {EVAL_OPTIONS[ia][0]} / {EVAL_OPTIONS[ib][0]}, top two "
            f"{top2[1] - top2[0]:.4f} apart; logits {[round(t, 4) for t in x]} / "
            f"{[round(t, 4) for t in y]}")


def phase_eval(cfg, model) -> tuple[dict, dict, dict]:
    """The benchmark harnesses (``livecc_tpu_torch/eval``) on main's 7B:
    a 720p VideoMME item through ``videomme.run`` at batch 1 and 2, K3 and
    K4's forward at its shapes against their blocked plain versions, the
    reduced item's forward against the plain path, a LiveSports-3K CC
    event and a caption on the engine, and the tiny model's MVBench run
    through ``eval.cli.main`` over a frame directory where Pillow is
    installed. Returns the MCQ runs' launch counts, the CC event's and the
    eval kernels' results."""
    import importlib.util
    import tempfile

    import torch

    from livecc_tpu_torch.data.tokenizer import ByteTokenizer
    from livecc_tpu_torch.eval import mcq, videomme
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import profile_stream
    from livecc_tpu_torch.utils import flops
    from livecc_tpu_torch.vision_io.budget import VisionBudget

    hw = VisionBudget().spatial_target(*EVAL_SOURCE_HW, nframes=EVAL_FRAMES)
    rows, clips = eval_items(EVAL_FRAMES, hw, EVAL_QUESTIONS)
    asked = []

    def loader(path):
        asked.append(path)
        return FramesVideo(clips[path], EVAL_FPS, source_hw=EVAL_SOURCE_HW)

    tok = ByteTokenizer.for_config(cfg)
    predictor = mcq.MCQPredictor(model, cfg, tok, video_loader=loader)
    host, fwd = [], []
    timed_calls(predictor, "encode_item", host)
    timed_calls(predictor, "letter_logits", fwd)
    log(f"  VideoMME items: {len(rows)} clips of {EVAL_FRAMES} frames of a "
        f"{EVAL_SOURCE_HW[0]}x{EVAL_SOURCE_HW[1]} source at {EVAL_FPS:g} fps, served at the "
        f"budget's {hw[0]}x{hw[1]}")
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        bench = os.path.join(tmp, "videomme.jsonl")
        with open(bench, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
        build.reset_launch_counts()
        for bs in (1, 2):
            out = os.path.join(tmp, f"batch{bs}")
            n0 = len(fwd)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            report = videomme.run(predictor, bench, out, batch_size=bs)
            wall = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated() - held) / 2**30
            files = sorted(os.listdir(out))
            want = ["results_no_subtitles.json", "results_no_subtitles.txt",
                    "videomme_no_subtitles.json", "videomme_shard0.json"]
            if report is None or report["n"] != len(rows) or files != want:
                raise AssertionError(f"eval batch {bs}: report {report}, files {files}")
            with open(os.path.join(out, "videomme_no_subtitles.json")) as f:
                preds = json.load(f)["predictions"]
            runs[bs] = [x for _, x in fwd[n0:]]
            log(f"  videomme.run batch_size={bs}: {wall:.3f} s for {len(rows)} items, predictions "
                f"{preds}, report written and merged ({report['overall']}% of {report['n']}); "
                f"peak device memory {peak:.2f} GiB above the model's")
        counts = dict(build.launch_counts)
    if asked != [r["video"] for r in rows] * 2:
        raise AssertionError(f"eval: the predictor read {asked}")
    same_letters("eval batch 1 against batch 2", runs[1], runs[2])
    log(f"  launches of the two runs: {counts}")
    missing = [k for k in EVAL_KERNELS if counts.get(k, 0) <= 0]
    if missing or counts.get("train_attention_bwd"):
        raise AssertionError(f"eval: the MCQ path launched {counts}")

    # per group: host (frames, patchify, ids, positions) and the forward
    enc = host[0][1]
    n_real = enc["ids"].shape[1]
    s = mcq._bucket(n_real)
    patches, grid = enc["patches"].shape[0], enc["grid"]
    for i, ((h_s, _), (f_s, _)) in enumerate(zip(host[:2], fwd[:2])):
        log(f"  batch 1 item {i}: host {h_s:.3f} s + forward {f_s:.3f} s = {h_s + f_s:.3f} s")
    for (f_s, x) in fwd[2:3]:
        log(f"  batch 2 group: host {host[2][0] + host[3][0]:.3f} s + forward {f_s:.3f} s")
    log(f"  item: {n_real} tokens ({patches // 4} visual) in the {s} bucket, grid {grid}: "
        f"{patches} patches, {grid[0]} groups of g = {grid[1] * grid[2]}; K4 pairs: pad share "
        f"{causal_pairs((), s - n_real) / causal_pairs((n_real,), s):.3f}")
    store = {}
    torch.cuda.synchronize()
    with attention_swapped(store=store), \
            torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        h0 = time.perf_counter()
        item = predictor.encode_item(mcq.MCQItem(video=rows[0]["video"],
                                                 question=rows[0]["question"],
                                                 options=rows[0]["options"]))
        h_s = time.perf_counter() - h0
        logits = predictor.letter_logits([item], videomme.LETTERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = profile_stream.busy_seconds(prof)
    groups = profile_stream.device_groups(prof)
    total = sum(groups.values())
    model_flops = (flops.llm_forward_flops(cfg.text, s) + flops.vit_forward_flops(
        cfg.vision, patches, grid[1] * grid[2]) + flops.lm_head_flops(cfg.text, 1))
    log(f"  profiled item: wall {wall:.3f} s (host {h_s:.3f} s), device busy {busy:.3f} s, idle "
        f"share {1 - busy / wall:.3f}; model {model_flops / 1e12:.1f} TFLOP, "
        f"{model_flops / wall / 1e12:.1f} TFLOP/s of the wall, {model_flops / busy / 1e12:.1f} "
        f"of the busy time")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:28s} {t * 1e3:10.2f} ms  {t / total:6.1%} of device time")
    if not torch.equal(logits, runs[1][0]):
        raise AssertionError("eval: the profiled item's logits differ from batch 1's")
    results = eval_kernels(store, n_real)
    del store, enc, item, host
    torch.cuda.empty_cache()
    eval_reduced(cfg, model, tok)
    cc_counts = eval_cc(cfg, model)
    if importlib.util.find_spec("PIL") is None:
        log("  mvbench (tiny model, frame directory): Pillow is not installed on this machine; "
            "eval.cli.main mvbench is not run")
    else:
        eval_mvbench_tiny()
    return counts, cc_counts, results


def heaviest_key_tile(q, k, allowed) -> int:
    """The 64-key tile (``kernel_check.TILE``) that carries most of the
    softmax mass of a query tile, among those that hold under 0.99 of every
    row's (so that the rows keep other keys): fp32 q [r, D] (scaled), k
    [n, D], allowed bool [r, n]. A planted dropped tile there moves the
    output most."""
    import torch

    from livecc_tpu_torch.tools import kernel_check

    sc = torch.where(allowed, q @ k.T, torch.full((), float("-inf"), device=q.device))
    p = torch.softmax(sc, dim=-1)
    tiles = -(-p.shape[1] // kernel_check.TILE)
    p = torch.nn.functional.pad(p, (0, tiles * kernel_check.TILE - p.shape[1]))
    mass = p.reshape(p.shape[0], tiles, kernel_check.TILE).sum(-1)        # [r, tiles]
    total = torch.where(mass.amax(0) < 0.99, mass.sum(0), torch.full((), -1.0, device=q.device))
    if not bool((total > 0).any()):
        raise AssertionError("heaviest_key_tile: every key tile holds a row's whole mass")
    return int(total.argmax())


def eval_kernels(store: dict, n_real: int) -> dict:
    """K3 and K4's forward at the item's shapes against ``kernel_check``'s
    blocked plain versions (group by group; 1024 query rows at a time) by
    ``kernel_check.close``: on the profiled item's last ViT block's and last
    LLM layer's q, k and v, and on random inputs of the same shapes (K4: the
    item's segments), where a dropped key tile (the heaviest of a query
    tile) must fail the limit. On the item's own inputs the same fault is
    printed, not required to fail: one tile of 64 among thousands of keys
    the softmax spreads over may move no output past the limit. Times on
    the item's inputs (``cuda_ms``, and device time) beside the bound and
    SDPA."""
    import torch

    from livecc_tpu_torch.ops.attention import prescaled, segment_ids as seg_of
    from livecc_tpu_torch.ops.train_attention import train_attention_fwd
    from livecc_tpu_torch.ops.vit_attention import vit_group_attention
    from livecc_tpu_torch.tools import kernel_check

    bf16, tile = torch.bfloat16, kernel_check.TILE
    gen = torch.Generator(device=store["vit"][0].device).manual_seed(14)
    results = {}

    def randn_like(x):
        return torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)

    def vit_check(q, k, v, label, required):
        ng, g, h, d = q.shape
        out = vit_group_attention(q, k, v)
        ref = kernel_check.vit_group_attention_blocked(q, k, v)
        qt = (g - 1) // tile
        rows = slice(qt * tile, g)
        kt = heaviest_key_tile(q[-1, rows, 3].float() * d ** -0.5, k[-1, :, 3].float(),
                               torch.ones((g - rows.start, g), dtype=torch.bool, device=q.device))
        qn, kn, vn, rn = (x.reshape(ng * g, h, d) for x in (q, k, v, ref))
        fault = kernel_check.vit_drop_key_tile(rn, qn, kn, vn, list(range(0, (ng + 1) * g, g)),
                                               ng - 1, qt, kt, head=3)
        return held("vit_group_attention", label, out, ref, fault.view(ref.shape), required,
                    f"dropped key tile {kt} of query tile {qt}")

    def k4_check(qs, k, v, seg, label, required):
        s, hq, hk = qs.shape[1], qs.shape[2], k.shape[2]
        o, lse = train_attention_fwd(qs, k, v, seg)
        ro, rlse = kernel_check.train_attention_fwd_blocked(qs, k, v, seg)
        qt = n_real // tile - 1                     # the item's last full query tile
        rows = slice(qt * tile, (qt + 1) * tile)
        pos = torch.arange(s, device=qs.device)
        kt = heaviest_key_tile(qs[0, rows, 3].float(), k[0, :, 3 // (hq // hk)].float(),
                               (pos[None, :] <= pos[rows, None]) & (seg[0, None, :] == 1))
        bad_o, _ = kernel_check.dropped_fwd_tile(qs, k, v, seg, ro, rlse, qt, kt, 3)
        lse_share = kernel_check.close(lse, rlse, torch.float32)
        log(f"  {'train_attention_fwd':20s} {label} lse: worst {lse_share:.3f} of the fp32 "
            f"limit")
        if not lse_share <= 1.0:
            raise AssertionError(f"train_attention_fwd {label}: lse {lse_share:.3f}x the limit")
        return held("train_attention_fwd", label, o, ro, bad_o, required,
                    f"dropped key tile {kt} of query tile {qt}")

    with torch.inference_mode():
        q, k, v = store["vit"]
        ng, g, h, d = q.shape
        shape = f"NG={ng} g={g} H={h} D={d} bf16"
        err = vit_check(q, k, v, f"{shape} (the item's last ViT block)", False)
        err = max(err, vit_check(*(randn_like(x) for x in (q, k, v)), f"{shape} (random)", True))
        results["vit_group_attention"] = timed_eval(
            "vit_group_attention", shape, err,
            fns=(lambda: vit_group_attention(q, k, v),
                 lambda: kernel_check.vit_group_attention_blocked(q, k, v)),
            library=sdpa_eval(q, k, v, None), flops=4 * ng * g * g * h * d,
            nbytes=4 * ng * g * h * d * 2)

        q, k, v, mask = store["llm"]
        b, s, hq, d = q.shape
        hk = k.shape[2]
        qs, seg = prescaled(q), seg_of(q, mask)
        shape = f"B={b} S={s} segment {n_real} + pad {s - n_real} Hq={hq} Hk={hk} D={d} bf16"
        err = k4_check(qs, k, v, seg, f"{shape} (the item's last LLM layer)", False)
        err = max(err, k4_check(prescaled(randn_like(q)), randn_like(k), randn_like(v), seg,
                                f"{shape} (random)", True))
        pairs = causal_pairs((n_real,), s)
        results["train_attention_fwd"] = timed_eval(
            "train_attention_fwd", shape, err,
            fns=(lambda: train_attention_fwd(qs, k, v, seg),
                 lambda: kernel_check.train_attention_fwd_blocked(qs, k, v, seg)),
            library=sdpa_eval(qs[:, :n_real], k[:, :n_real], v[:, :n_real], True),
            flops=4 * pairs * d * hq,
            nbytes=2 * (2 * s * hq * d + 2 * s * hk * d) + 4 * s * hq + 4 * s)
        pad = causal_pairs((), s - n_real)
        log(f"  {'train_attention_fwd':20s} causal pairs {pairs} (pad {pad}, a {pad / pairs:.3f} "
            f"share of the work); SDPA is_causal over the {n_real} real tokens")
    return results


def held(name, label, out, ref, fault, required, note) -> float:
    """``close`` of a kernel's output against the blocked plain version,
    and of the planted fault (which must fail where ``required``); returns
    the max abs error."""
    import torch

    from livecc_tpu_torch.tools import kernel_check

    torch.cuda.synchronize()
    bf16 = torch.bfloat16
    worst, w_bad = kernel_check.close(out, ref, bf16), kernel_check.close(fault, ref, bf16)
    err = (out.float() - ref.float()).abs().max().item()
    log(f"  {name:20s} {label}: max_abs_err {err:.3e}, worst {worst:.3f} of the limit "
        f"{kernel_check.TOL[bf16]}; {note}: {w_bad:.2f}x"
        + ("" if required else " (not required to fail on these inputs)"))
    if not worst <= 1.0:
        raise AssertionError(f"{name} {label}: {worst:.3f}x the limit")
    if required and not w_bad > 1.0:
        raise AssertionError(f"{name} {label}: the check passes a dropped key tile")
    return err


def timed_eval(name, label, err, fns, library, flops, nbytes) -> dict:
    """One-call times (``cuda_ms``) of a kernel, its blocked plain version and
    SDPA, the kernel's device time (``graph_ms``) and the bound."""
    from livecc_tpu_torch.tools.kernel_timing import cuda_ms, graph_ms

    ms, plain_ms, lib_ms = cuda_ms(fns[0]), cuda_ms(fns[1], iters=3, warmup=1), cuda_ms(library)
    dev_ms = graph_ms(fns[0])
    b_ms, b_by = bound(flops, nbytes)
    log(f"  {name:20s} {label}: one call: kernel {ms:.4f}  blocked plain {plain_ms:.4f}  SDPA "
        f"{lib_ms:.4f} ms; device: kernel {dev_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}; "
        f"{flops / 1e12:.4f} TFLOP, {nbytes / 1e9:.4f} GB)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "graph_ms": dev_ms, "bound_ms": b_ms, "bound_by": b_by}


def sdpa_eval(q, k, v, causal):
    """The one PyTorch call beside an eval kernel: SDPA on K3's groups
    (``causal`` None: [NG, g, H, D], bidirectional), or on K4's real tokens
    (pre-scaled q [1, n, Hq, D], GQA, ``is_causal``)."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if causal is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=1.0,
                                                  enable_gqa=True)


def eval_reduced(cfg, model, tok) -> None:
    """The reduced item (``EVAL_REDUCED_FRAMES`` frames of
    ``EVAL_REDUCED_HW``, batch 2): its [B, 4] letter logits with K3 and K4
    against the same forward with their plain versions on the card."""
    import torch

    from livecc_tpu_torch.eval import mcq, videomme
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.ops.attention import train_attention_plain
    from livecc_tpu_torch.ops.vit_attention import vit_group_attention_plain
    from livecc_tpu_torch.tools import kernel_check

    rows, clips = eval_items(EVAL_REDUCED_FRAMES, EVAL_REDUCED_HW, EVAL_QUESTIONS)
    predictor = mcq.MCQPredictor(model, cfg, tok, video_loader=lambda p: FramesVideo(
        clips[p], EVAL_FPS))
    group = [predictor.encode_item(mcq.MCQItem(video=r["video"], question=r["question"],
                                               options=r["options"])) for r in rows]
    build.reset_launch_counts()
    kernels = predictor.letter_logits(group, videomme.LETTERS)
    counts = dict(build.launch_counts)
    with attention_swapped(vit_group_attention_plain, train_attention_plain):
        plain = predictor.letter_logits(group, videomme.LETTERS)
    plain_counts = {k: v - counts.get(k, 0) for k, v in build.launch_counts.items()}
    worst = kernel_check.close(kernels, plain, torch.bfloat16)
    n = [x["ids"].shape[1] for x in group]
    log(f"  reduced items: {len(group)} x {EVAL_REDUCED_FRAMES} frames of "
        f"{EVAL_REDUCED_HW[0]}x{EVAL_REDUCED_HW[1]}, grid {group[0]['grid']}, {n} tokens in the "
        f"{mcq._bucket(max(n))} bucket: letter logits with the kernels against the plain path "
        f"worst {worst:.3f} of the bf16 limit {kernel_check.TOL[torch.bfloat16]}; kernels "
        f"{kernels.tolist()}, plain {plain.tolist()}; launches {counts}, plain path "
        f"{plain_counts}")
    if not worst <= 1.0:
        raise AssertionError(f"eval reduced item: the kernels' letter logits {worst:.3f}x the "
                             f"limit from the plain path's")
    if any(counts.get(k, 0) <= 0 for k in EVAL_KERNELS) or any(
            plain_counts.get(k, 0) for k in EVAL_KERNELS):
        raise AssertionError(f"eval reduced item: launches {counts}, plain path {plain_counts}")


def eval_cc(cfg, model) -> dict:
    """A LiveSports-3K CC event (``CC_SECONDS`` s at 2 fps of 308x560)
    through ``livesports3kcc.generate`` on ``session.new_engine``: its rows
    equal a direct ``live_cc_once_for_evaluation``; wall and FLOP rate
    (``serving_chunk_flops``); then one caption through
    ``captions.generate_captions``. Returns the event's launch counts."""
    import tempfile

    import torch

    from livecc_tpu_torch.eval import captions, livesports3kcc
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import session
    from livecc_tpu_torch.utils import flops
    from livecc_tpu_torch.vision_io.patchify import grid_for_frames

    engine = session.new_engine(cfg, model)
    frames = session.synth_frames(2 * CC_SECONDS, session.HEIGHT, session.WIDTH, seed=30)
    event = {"video_id": "match0", "event_id": "e0", "begin": 120.0, "end": 120.0 + CC_SECONDS,
             "title": "Cup final", "preASR": "and the corner is swung in", "video": "match0.mp4"}

    def read_clip(ev):
        if ev is not event:
            raise AssertionError(f"read_clip got {ev}")
        return frames

    with tempfile.TemporaryDirectory() as tmp:
        n0 = len(engine.chunk_log)
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merged = livesports3kcc.generate(engine, [event], tmp, read_clip=read_clip)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(build.launch_counts)
        with open(merged) as f:
            row = json.loads(f.readline())
        chunks = engine.chunk_log[n0:]
        direct = engine.live_cc_once_for_evaluation(
            livesports3kcc.build_commentary_query(event["title"], event["preASR"]), frames,
            video_start=event["begin"], max_new_tokens=32, repetition_penalty=1.15)
        if row["chunks"] != direct or row["event_id"] != "e0":
            raise AssertionError(f"eval cc: generate's rows {row['chunks']} against the direct "
                                 f"call's {direct}")
        total, kv = 0, 0
        sizes = [engine.initial_fps_frames] + [engine.streaming_fps_frames] * len(chunks[1:])
        for rec, n in zip(chunks, sizes):
            grid = grid_for_frames(n, session.HEIGHT, session.WIDTH, cfg.vision)
            total += flops.serving_chunk_flops(cfg, rec.prompt_tokens, kv, rec.generated_tokens,
                                               grid[0] * grid[1] * grid[2], grid[1] * grid[2])
            kv += rec.prompt_tokens + rec.generated_tokens
        log(f"  livesports3kcc.generate: one {CC_SECONDS} s event, {len(chunks)} chunks in "
            f"{wall:.3f} s, {total / wall / 1e12:.2f} model TFLOP/s (serving_chunk_flops); rows "
            f"= a direct live_cc_once_for_evaluation; pred {row['pred'][:60]!r}; launches {counts}")
        missing = [k for k in MAIN_KERNELS if counts.get(k, 0) <= 0]
        n_chunks = 1 + (2 * CC_SECONDS - engine.initial_fps_frames) // engine.streaming_fps_frames
        if missing or not len(row["chunks"]) == len(chunks) == n_chunks:
            raise AssertionError(f"eval cc: {len(row['chunks'])} chunks, launches {counts}")
        t0 = time.perf_counter()
        path = captions.generate_captions(engine, [event], os.path.join(tmp, "cap"),
                                          read_clip=read_clip)
        with open(path) as f:
            cap = json.loads(f.readline())
        log(f"  captions.generate_captions: {time.perf_counter() - t0:.3f} s, caption of "
            f"{len(cap['caption'])} characters")
        if cap["event_id"] != "e0" or not isinstance(cap["caption"], str):
            raise AssertionError(f"eval caption: {cap}")
    return counts


def eval_mvbench_tiny() -> None:
    """``eval.cli.main mvbench`` on the tiny model on the card (the CLI's
    default device) over one item whose video is a directory of PNG frames."""
    import tempfile

    import numpy as np
    from PIL import Image

    from livecc_tpu_torch.eval import cli

    with tempfile.TemporaryDirectory() as tmp:
        frames_dir = os.path.join(tmp, "tvqa_clip")
        os.makedirs(frames_dir)
        for i, frame in enumerate(np.random.RandomState(40).randint(0, 256, (6, 56, 84, 3),
                                                                     dtype=np.uint8)):
            Image.fromarray(frame).save(os.path.join(frames_dir, f"{i:04d}.png"))
        bench = os.path.join(tmp, "mvbench.jsonl")
        with open(bench, "w") as f:
            f.write(json.dumps({"video": frames_dir, "question": "What happens?",
                                "candidates": ["a pass", "a goal", "a foul"], "answer": "a goal",
                                "task_type": "Action Sequence"}) + "\n")
        report = cli.main(["mvbench", "--benchmark", bench, "--output_dir",
                           os.path.join(tmp, "out"), "--max_frames", "4"])
    log(f"  mvbench through eval.cli.main (tiny model, cuda, frame directory): {report}")
    if not report or report["n"] != 1:
        raise AssertionError(f"eval mvbench: {report}")


def phase_tiny_train():
    """Three fp32 training steps of the tiny model on the CPU (plain
    versions) and on the GPU (K3, K4, fused CE with fp32 logit rows); then
    the gradients of one step with the ViT unfrozen, in fp32 and bf16, on
    the GPU (K3 forward, its autograd ``Function`` backward) against the
    CPU plain path's autograd by ``kernel_check.grad_close``, which a K3
    backward that returns zeros (``kernel_check.zeroed_k3_backward``) must
    fail."""
    import torch

    from livecc_tpu_torch.core.config import tiny_config
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import kernel_check
    from livecc_tpu_torch.tools.train_session import tiny_train_losses, tiny_vit_grads

    losses = []
    for dev in ("cpu", "cuda"):
        losses.append(tiny_train_losses(dev))
        log(f"  tiny train {dev}: losses {losses[-1]}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[1], losses[0]))
    if not rel <= 1e-4:
        raise AssertionError(f"tiny train: CPU and GPU losses differ by {rel:.2e} relative")
    ref32 = tiny_vit_grads("cpu")

    def worst(grads, ref):
        """(worst share, the parameter whose gradient it is)."""
        return max((kernel_check.grad_close(grads[n], ref[n], ref32[n]), n) for n in ref32)

    for dtype in (torch.float32, torch.bfloat16):
        ref = ref32 if dtype == torch.float32 else tiny_vit_grads("cpu", dtype)
        before = build.launch_counts["vit_group_attention"]
        share, name = worst(tiny_vit_grads("cuda", dtype), ref)
        launches = build.launch_counts["vit_group_attention"] - before
        with kernel_check.zeroed_k3_backward():
            fault, fault_name = worst(tiny_vit_grads("cuda", dtype), ref)
        log(f"  unfrozen ViT {str(dtype)[6:]}: {len(ref32)} ViT gradients, worst grad_close "
            f"{share:.3f} ({name}) against the CPU plain path; a zeroed K3 backward "
            f"{fault:.1f} ({fault_name}); {launches} K3 launches")
        # one K3 launch a ViT block in each of the step's two micro-batches
        if not share <= 1.0 or not fault > 1.0 or launches != 2 * tiny_config().vision.depth:
            raise AssertionError(f"unfrozen ViT {dtype}: grad_close {share}, zeroed backward "
                                 f"{fault}, {launches} K3 launches")


def phase_train() -> dict:
    """The 7B-width training session of tools/train_session.py: 3 steps."""
    import tempfile

    import torch

    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import kernel_timing
    from livecc_tpu_torch.tools import train_session as ts

    cfg = ts.train_model_config()
    t0 = time.perf_counter()
    samples = ts.synth_samples(cfg, ts.N_SAMPLES, ts.N_FRAMES, ts.HEIGHT, ts.WIDTH,
                               ts.TEXT_TOKENS)
    model = ts.train_model(cfg)
    torch.cuda.synchronize()
    lens = [x["input_ids"].shape[1] for x in samples]
    log(f"  {len(samples)} samples of {lens} tokens, grid {samples[0]['video_grid_thw'][0].tolist()}"
        f"; model {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params "
        f"(LLM depth {cfg.text.num_hidden_layers}) in {time.perf_counter() - t0:.1f} s")
    visual = {n: p.clone() for n, p in model.visual.named_parameters()}
    with tempfile.TemporaryDirectory() as out:
        trainer = ts.new_trainer(cfg, model, samples, out)
        # the first update has learning rate 0: what moves, moves in steps 2-3
        before = {n: p.detach().clone() for n, p in model.text.named_parameters()
                  if n.startswith("layers.0.") or n in ("final_ln.weight", "lm_head.weight")}
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        records = ts.run_steps(trainer)
        counts = dict(build.launch_counts)
        peak = torch.cuda.max_memory_allocated() / 2**30
    for rec in records:
        log(f"  step {rec['step']}: wall {rec['wall_s'] * 1e3:9.2f} ms  loss {rec['loss']:.4f}  "
            f"tokens {rec['tokens']} ({rec['supervised']} supervised)  "
            f"{rec['tokens_per_s']:.0f} tokens/s  model {rec['model_tflops']:.1f} TFLOP/s")
    log(f"  peak memory {peak:.2f} GiB; launches {counts}")
    if len(records) != 3 or not all(torch.isfinite(torch.tensor(r["loss"])) for r in records):
        raise AssertionError(f"train: expected 3 finite losses, got {records}")
    # bf16 norm scales sit at 1.0, where an update of ~lr (2e-5) is below half
    # a bf16 step (2^-8): they cannot move, in JAX's bf16 training either
    stay = [n for n in before if n.endswith("ln.weight")]
    moved = [n for n, p in model.text.named_parameters() if n in before
             and not torch.equal(p, before[n])]
    if set(moved) != set(before) - set(stay):
        raise AssertionError(f"train: params that did not move: "
                             f"{sorted(set(before) - set(stay) - set(moved))}")
    log(f"  moved after step 2: {len(moved)} of the {len(before)} checked tensors (layer 0, "
        f"final_ln, lm_head); bf16 norm scales at 1.0 unchanged: {sorted(set(stay) - set(moved))}")
    if not all(torch.equal(p, visual[n]) for n, p in model.visual.named_parameters()):
        raise AssertionError("train: the frozen ViT changed")
    missing = [name for name in TRAIN_KERNELS if counts.get(name, 0) <= 0]
    if missing:
        raise AssertionError(f"the training path never launched {missing}")
    shapes = {rec["vit_shape"] for rec in records}
    log(f"  K3 calls (NG, g): {sorted(shapes)}; the kernels phase timed "
        f"{kernel_timing.VIT_SHAPES[-1]}")
    if shapes != {kernel_timing.VIT_SHAPES[-1]}:
        raise AssertionError(f"train: K3 ran at {shapes}, not at the timed training shape "
                             f"{kernel_timing.VIT_SHAPES[-1]} (tools/kernel_timing.py)")
    del model, trainer, samples
    return counts


def run_phase(name: str, fn):
    log(f"== phase {name}")
    t0 = time.perf_counter()
    r = fn()
    log(f"== phase {name} ok in {time.perf_counter() - t0:.1f} s")
    return r


def main() -> int:
    sys.path.insert(0, ROOT)
    card = phase_device()
    import torch

    from livecc_tpu_torch.tools import session

    t_all = time.perf_counter()
    run_phase("build", phase_build)
    results = run_phase("kernels", phase_kernels)
    run_phase("tiny", phase_tiny)
    run_phase("tiny_pool", phase_tiny_pool)
    run_phase("tiny_w8", phase_tiny_w8)
    t0 = time.perf_counter()
    cfg, model = session.main_model()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"7B init: {n_params / 1e9:.3f} B params bf16 in {time.perf_counter() - t0:.1f} s")
    main_counts, main_record, main_sum = run_phase("main", lambda: phase_main(cfg, model))
    pool_counts, pool_record, pool_sum = run_phase("pool", lambda: phase_pool(cfg, model))
    spec_counts, adversarial_counts = run_phase(
        "main_spec", lambda: phase_main_spec(cfg, model, main_record, main_sum["step_ms"]))
    pool_spec_counts = run_phase(
        "pool_spec", lambda: phase_pool_spec(cfg, model, pool_record, pool_sum["step_ms"]))
    del pool_record
    # the same 7B with int8 weights, drawn from the same seed and quantized
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, model_w8 = session.main_model(w8=True)
    torch.cuda.synchronize()
    w8_init = {"seconds": time.perf_counter() - t0,
               "gib": (torch.cuda.memory_allocated() - held) / 2**30,
               "peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30,
               "bytes_gib": session.model_bytes(model_w8) / 2**30,
               "bf16_gib": session.model_bytes(model) / 2**30}
    main_w8_counts, main_w8_spec_counts = run_phase(
        "main_w8", lambda: phase_main_w8(cfg, model_w8, main_record, main_sum, w8_init))
    pool_w8_counts = run_phase("pool_w8", lambda: phase_pool_w8(cfg, model_w8, pool_sum))
    del main_record, model_w8
    gc.collect()
    torch.cuda.empty_cache()
    eval_counts, cc_counts, _ = run_phase("eval", lambda: phase_eval(cfg, model))
    gc.collect()
    torch.cuda.empty_cache()
    models = [model]
    del model                                # checkpoint_live frees the serving 7B
    checkpoint_counts, checkpoint_w8_counts = run_phase(
        "checkpoint_live", lambda: phase_checkpoint_live(cfg, models))
    gc.collect()
    torch.cuda.empty_cache()
    run_phase("tiny_train", phase_tiny_train)
    train_counts = run_phase("train", phase_train)
    kernels = [{
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": sum(c.get(name, 0) for c in (main_counts, pool_counts, spec_counts,
                                                 adversarial_counts, pool_spec_counts,
                                                 main_w8_counts, main_w8_spec_counts,
                                                 pool_w8_counts, eval_counts, cc_counts,
                                                 checkpoint_counts, checkpoint_w8_counts,
                                                 train_counts)),
        "max_abs_err": results[name]["max_abs_err"],
        "ms": results[name]["ms"],
        "plain_ms": results[name]["plain_ms"],
        "bound_ms": results[name]["bound_ms"],
        "bound_by": results[name]["bound_by"],
        "library_ms": results[name]["library_ms"],
    } for name, (src, replaces) in KERNELS.items()]
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
                 group of G * D = 4096 (two launches). K2 and K2-int8 are
                 also captured in a CUDA graph at the pool's shape and
                 replayed twice after new kv_limit values are written in
                 place: each replay must give an eager launch's bits, stay
                 within ``close`` of the plain version and leave the
                 kernel's arrival counters at zero
                 (``decode_replay``). K1 and K1-int8 are
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
                 bit-equal (``phase_k4``). K4's non-causal form
                 (``causal=False``, splash's ``FullMask``; on no path) at the
                 same shapes (``phase_k4_noncausal``): held by ``close`` and
                 ``grad_close`` by limits that the causal walk and mask kept
                 under ``causal=False`` (``kernel_check.causal_walk``) must
                 fail, two bf16 launches bit-equal, and at S = 8192 kernel,
                 plain version and SDPA with the segment block mask timed
                 beside the bound (the kernels line's ``noncausal`` key of
                 the two K4 entries). K4 at one tensor-parallel rank's heads
                 of the 7B (``phase_k4_tp``: Hq = 14, Hk = 2 for M = 2;
                 Hq = 7, Hk = 1 for M = 4) on the timed K4 case's packed
                 rows, held by ``close`` and ``grad_close`` (a dropped tile
                 pair must fail), timed beside bound and SDPA (the K4
                 entries' ``tp`` key). K5 (``phase_k5``) at
                 ``kernel_timing.W8_SHAPES`` (decode and verify-window rows
                 on gate_proj, down_proj, k_proj and the fp32 lm_head,
                 prefill rows on gate_proj and down_proj, the ViT's fc1),
                 held by ``kernel_check.close`` in the output's dtype, a
                 limit that a dropped K split (small form, M <= 16) or one
                 dropped 64-wide K stage of one output tile of
                 ``quant.large_plan``'s tiling (large form) must fail; two
                 launches bit-equal; kernel, plain version and torch.mm on
                 the bf16 weight timed both ways beside the bound.
     kernels_tp — the serving kernels at one tensor-parallel rank's shapes
                 of the 7B (``phase_kernels_tp``; Hq = 14, Hk = 2 for M = 2,
                 Hq = 7, Hk = 1 for M = 4): K1 at Sq = 256 and 9, K2 at
                 B = 1 and 8, K1-int8 and K2-int8 on the pool's int8 cache
                 at Hk / M, K5 on a rank's share of q / k / gate (N / M),
                 o / down (K / M) and the lm_head (V / M) at 1 and 256
                 tokens; each held by ``close`` with its planted fault
                 failing, two launches bit-equal, timed both ways beside
                 the bound and SDPA / torch.mm (the entries' ``tp`` key).
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
     tiny_asr  — the tiny Whisper in fp32 (``models/whisper``): CPU and GPU
                 give identical greedy tokens on three seeded mels, to EOS
                 and with EOS out of reach (to the clamp).
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
     tp_serve  — tensor-parallel serving (``phase_tp_serve``): one rank's
                 ``shard_params`` of a fresh bf16 7B at M = 2 and 4 (bytes
                 freed, peak); then ``init_mesh("1x1", "cuda")`` over NCCL
                 and ``shard_params`` on main's and pool_w8's models: main's
                 session and pool_w8's pool through the decode graphs,
                 tokens identical to theirs, the collectives captured into
                 the graphs, walls and each rank's weight and KV bytes
                 beside theirs, one steady chunk profiled. With 2 or 4
                 cards also 1x2 / 1x4 through torchrun (``--tp-worker``),
                 held to the no-mesh tokens up to a near-tie.
     memory_plan — ``parallel/memory.py``'s plans against the bytes on the
                 card (``phase_memory_plan``): weights bf16 at TP = 1 and
                 one rank at M = 2 and 4 exactly, int8 within 1%; main's
                 bf16 KV exactly and the pool's int8 KV as plan plus
                 scales exactly; a one-process ``Zero2``'s state exactly,
                 and at n_data = 8 its fp32 gradient (the partition and
                 the staging bucket) as the bytes the allocator gives back;
                 the 7B's plans on this card with the streams that fit (a
                 memory bound); then ``tools/layer_costs.py``'s probes
                 (decode, prefill, training; K1, K2, K4) with the
                 calibration before and after, the 28-layer decode
                 projection beside main's step replay and the training
                 linearity check logged as findings.
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
     asr       — Whisper large-v3-turbo at full width and depth
                 (``phase_asr``): fp32 weights drawn on the card from a
                 seed, written as an HF checkpoint under build/
                 (``save_whisper_checkpoint``), loaded by
                 ``tools/asr.py:WhisperTranscriber`` in bf16 on the card;
                 90 s of seeded PCM through its ``audio_loader`` in 3
                 segments, each decoded greedily (to the 447-token cap on
                 random weights); words in every segment; segment 0's
                 encoder states and first-step logits within
                 ``ASR_REL_TOL`` of the checkpoint in fp32 on the card.
                 Wall, each segment's encode / decode seconds and tokens,
                 the real-time factor, peak memory.
     produce   — the corpus scorers on main's 7B (``phase_produce``):
                 ``tools/lmm4asd.py:TalkingHeadPredictor`` over 64 seeded
                 clips (8 frames each as images of 308x168: 512 ViT groups
                 of g = 264, rows of ~730 tokens in the 1024 bucket) at
                 batch 64, and at batch 1 on 4 of them (within
                 ``LMM_LOG_TOL`` in log space); ``tools/filters.py:
                 lm_loss_scores`` on 8 transcripts of 1025-1985 tokens;
                 each again under the profiler (bit-equal; busy, idle,
                 device time by group); the asr phase's words through
                 ``clips_for_pretrain`` -> ``to_conversation`` ->
                 ``write_corpus`` and one row read back by ``LMMDataset``.
                 Then K3 at NG = 512, g = 264 and K4's forward at B = 64,
                 S = 1024 (pads as segment 0) and at B = 1, S = 2048 on
                 random bf16 inputs (``produce_kernels``): held by
                 ``close`` against the blocked plain versions, a dropped
                 key tile failing; two launches bit-equal; kernel, plain
                 and SDPA timed beside the bound (the kernels line's
                 ``produce`` key of K3 and K4's forward).
     asd       — the active-speaker filter (``phase_asd``): a 5-minute
                 video of 160x288 (H x W) at 25 fps (7,500 seeded frames;
                 10 windows of 150 every 750, 1,500 detector frames) and
                 300 s of PCM through ``asd.mfcc``; SCRFD through
                 ``scrfd.load_onnx_detector`` on the seeded 44-node test
                 graph (``tools/scrfd_synth.py``) the port's ``onnx_lite``
                 writes, IoU tracks, Light-ASD (seeded) on each track's
                 tube and on 10 planted 150-frame tubes. Card against CPU:
                 the first window's raw outputs, boxes and tracks,
                 ``make_detector`` at ``ScrfdConfig``'s defaults (raw
                 outputs, boxes), a tube's logits. The chain's wall split into host and
                 device calls, detector and Light-ASD times (one call,
                 CUDA events, device busy), tracks, the ratio, peak
                 memory, a profiled window. No hand-written kernel.
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
     app       — the web demo on that checkpoint (``phase_app``, inside
                 checkpoint_live): ``vision_io.device_preprocess`` on a
                 2-frame 720x1280 chunk resized to 308x560, within 1e-4 of
                 the CPU in fp32, two launches bit-equal, timed; then
                 ``demo.app.DemoServer`` (``build_engine``,
                 ``load_checkpoint``; the clip from an .npy file through a
                 ``video_loader`` where FFmpeg is absent) behind a threaded
                 HTTP server on 127.0.0.1, twice: bf16, and lookahead with
                 int8 weights. A client plays the clip as the page does:
                 ``GET /``, ``GET /video`` (the file's bytes), a ``GET
                 /tick`` every 0.5 s of wall on a thread of its own
                 (overlapping) to the clip's end plus 1 s, one ``POST
                 /qa``. The bubbles and the answer must equal
                 ``LiveCC.live_cc`` replayed over the admitted t (in the
                 lock's order; lookahead: the same dispatch choices) and
                 ``video_qa`` on a fresh session; K3, K1, K2 (and K5 and
                 verify windows) launched. Tick latency, span lag, lock
                 waits, QA latency, load seconds; with FFmpeg, the
                 commentary video rendered with the built-in TTS.
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
 13. train_cli — the training front door (``phase_train_cli``):
                 ``python -m livecc_tpu_torch.train.cli``'s ``main`` on an
                 HF checkpoint of train's configuration (7B width, LLM depth
                 4, bf16, written under build/) over a seek-indexed JSONL
                 corpus in the Live-CC-5M schema: streaming rows of 30, 60
                 and 120 s of a 360x640 source (2 fps frames interleaved
                 with ASR words at 2.5 a second through ``LMMDataset``) and
                 a plain QA row, frames from ``SeededSource`` where FFmpeg is
                 absent. Each sample's length, bucket and K3 shape printed
                 (one must be in the 32768 bucket); 3 steps of 2 micro-batches
                 (no packing, remat=True), then a second call that resumes
                 from step 3 (restored parameters bit-equal to those saved)
                 and takes step 4: finite losses, no dataset retries, the
                 checked text parameters moved, the ViT unchanged, K3 and
                 K4 fwd/bwd launched; each step's wall, tokens, rates and
                 peak memory, state.pt's save and restore seconds and size.
                 Then one 32768-bucket micro-step under remat True, "names",
                 "names_mlp" and "dots" (losses bit-equal, gradients within
                 ``grad_close`` of remat=True's against the fp32 micro-step;
                 wall and peak each) and one profiled (device time by group,
                 K4's share, idle share). Last, K3 at each sample's (NG, g)
                 and K4's forward and backward at each bucket's longest row
                 against ``kernel_check``'s blocked plain versions (the
                 backward by ``grad_close``; a dropped tile must fail each
                 check), timed at 32768.
     mesh      — multi-device training (``phase_mesh``): ``train.cli``'s
                 ``main`` with train_cli's first run's flags and checkpoint
                 plus ``--mesh 1x1``, over NCCL at world size 1 (torchrun's
                 variables set in the process): the TP layers, the
                 vocab-parallel CE and the flat ZeRO-2 update with every
                 collective issued. Steps 1-2's losses those of train_cli's
                 run within 1e-6 relative, step 3's within ``close``'s bf16
                 limit; K3 and K4 fwd/bwd launched; NCCL collectives in step 3's
                 profile (count, device time, idle share); no bf16 .grad
                 alive after any backward (ZeRO-2's hooks take each one),
                 each step's peak and where it lies;
                 the step-3 state.pt loads in the no-mesh ``Trainer``.
                 With 2 or 4 cards also ``--mesh 2x1`` / ``2x2`` through
                 torchrun (this script's ``--mesh-worker`` mode), held to
                 the 1x1 losses, each rank printing its partition's bytes.
     sp_pp     — sequence and pipeline parallelism (``phase_sp_pp``) on
                 train_cli's checkpoint over NCCL at world size 1: ``Trainer``
                 with ``TrainConfig(seq_shard=True)`` at 1x1 for 3 steps of
                 train_cli's corpus (steps 1-2's losses ``mesh``'s within
                 1e-6, step 3's within ``close``'s bf16 limit; K3 and K4
                 fwd/bwd launched; step 3 profiled, its all-gathers and
                 reduce-scatters those the code implies); then
                 ``make_pp_train_step`` at 1 stage for 2 steps of a text
                 window of 4 x 8192 tokens against ``make_mesh_train_step``
                 at 1x1 on the same window (losses within 1e-6, no
                 point-to-point call, K4 launched); walls, peaks and idle
                 shares beside the runs they are held to. With 2 cards also
                 SP at 1x2 and PP at 2 stages through torchrun.
 14. midsize   — the port's forward at the 7B's width (4 LLM layers, 4
                 ViT blocks; weights from ``utils/param_recipe.py``)
                 against HF's golden ``tests/goldens/hf_midsize.npz``
                 (``tools/midsize.py``): text, multimodal with its
                 positions, the streaming continuation and the vision
                 tower through K4's forward, K3 and K1; fp32 within JAX's
                 limits, then the model rounded to bf16 within
                 ``midsize.BF16``.

Launch counts are reset just before each of main, pool, main_spec (and
its worst case), pool_spec, main_w8 (and its lookahead session), pool_w8,
tp_serve's session and pool, memory_plan's probes, eval's two VideoMME runs and its CC event, checkpoint_live's two CLI runs,
app's two playbacks (with their QA turns), train, train_cli's two CLI runs,
mesh's run, sp_pp's SP and PP runs, produce's batch and lm_loss runs and
midsize's two runs and read just after; every kernel of that path must have launched. Every phase
always runs. After all of them passed it prints one JSON line ``{"kernels": [...]}``
and, as its last line, ``{"ok": true, "device": {...}}``. It imports nothing
of JAX.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import shutil
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
# kv_limit values written into a captured decode graph's buffer at the
# pool's B = 8 (``decode_replay``): split edges, a row of none, the cache's end
REPLAY_LIMITS = [2, 800, 8000, 4100, 0, 65, 513, 3000]
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
# K4 at one tensor-parallel rank's heads of the 7B (Hq / M, Hk / M) for M = 2 and 4,
# on the packed rows of K4_CASES' timed case
K4_TP_HEADS = ((2, 14, 2), (4, 7, 1))
# and the one-segment yardstick's long form: forward and backward at the eval
# and train_cli rows' bucket
K4_LONG_S = 32768
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
# app: the web demo on that clip, polled every APP_POLL_S of wall as the page
# polls (a tick admitted more than APP_WAITED_S after it arrived waited on the
# lock), one question; device_preprocess on APP_SOURCE_HW frames
APP_POLL_S, APP_WAITED_S = 0.5, 1e-3
APP_QUESTION = "What happened in the video?"
APP_SOURCE_HW = (720, 1280)
# train_cli: streaming rows of CLI_CLIPS seconds of a CLI_SOURCE_HW source at
# CLI_SOURCE_FPS, ASR words at CLI_WORDS_PER_S (live speech), and a plain QA
# row over the first clip; the remat policies of the A/B
CLI_CLIPS, CLI_SOURCE_HW, CLI_SOURCE_FPS, CLI_WORDS_PER_S = (30, 60, 120), (360, 640), 2.0, 2.5
CLI_SEED = 3
CLI_QUERY = "Please commentate on the match live."
CLI_QUESTION, CLI_ANSWER = "Which team scores first?", "The team in red, from a corner."
CLI_VOCAB = ("pass", "shot", "goal", "cross", "header", "save", "corner", "tackle", "through",
             "ball", "keeper", "wide", "striker", "midfield", "counter", "press", "offside",
             "foul", "free", "kick", "and", "the", "he", "into", "box", "what", "a", "finish")
CLI_REMATS = (True, "names", "names_mlp", "dots")
# asr: Whisper large-v3-turbo from seed ASR_SEED on ASR_SECONDS s of seeded
# PCM; bf16 against fp32 on the card, ||bf16 - fp32|| / ||fp32||
ASR_SECONDS, ASR_SEED, ASR_REL_TOL = 90, 5, 5e-2
# produce: the lmm4asd filter over LMM_CLIPS clips (LMM_SECONDS s of an
# LMM_SOURCE_HW source at LMM_FPS) at batch LMM_BATCH, and at batch 1 on
# LMM_SINGLE of them, whose P('Yes') must stay within LMM_LOG_TOL of the
# batch's in log space; lm_loss on transcripts of about LM_LOSS_CHARS
# characters (1000-2048 tokens)
LMM_CLIPS, LMM_BATCH, LMM_SINGLE = 64, 64, 4
LMM_SECONDS, LMM_SOURCE_HW, LMM_FPS = 60, (360, 640), 2.0
LMM_LOG_TOL = 0.25
LM_LOSS_CHARS = (940, 1080, 1220, 1360, 1500, 1640, 1780, 1920)
PRODUCE_KERNELS = ("vit_group_attention", "train_attention_fwd")
# asd: the active-speaker filter over a 5-minute video at the reference's decode
# size (160x288, H x W) at 25 fps with 16 kHz audio: a seeded still scene plus
# per-frame sensor noise of up to ASD_NOISE grey levels; the detector the
# seeded 44-node test graph (tools/scrfd_synth.py, buffalo_sc's output
# contract, not det_500m's depth) at ch ASD_GRAPH_CH, and make_detector's
# seeded Scrfd, each with a score bias that puts ASD_FACES anchors of frame 0
# above the threshold and a box bias of ASD_BOX_BIAS strides (face-sized
# boxes); Light-ASD at its one size, seeded. GPU against CPU: the detectors'
# raw outputs within ASD_RAW_TOL (1 + |CPU|), their scores within
# ASD_SCORE_TOL (a box whose CPU score lies that near the threshold is
# reported, not counted), Light-ASD logits within ASD_LOGIT_TOL (fp32, TF32
# off)
ASD_SECONDS, ASD_FPS, ASD_HW, ASD_SR = 300, 25, (160, 288), 16000
ASD_SEED, ASD_NOISE, ASD_GRAPH_CH, ASD_FACES, ASD_BOX_BIAS = 17, 3, 16, 4, 2.0
ASD_SCORE_TOL, ASD_RAW_TOL, ASD_LOGIT_TOL = 1e-5, 1e-4, 1e-3
ASD_MAKE_FRAMES = 4            # frames through make_detector at ScrfdConfig's defaults
MIDSIZE_KERNELS = ("vit_group_attention", "train_attention_fwd", "flash_prefill")


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


# bf16 K1's and K3's kernels (csrc/wgmma_attention.cuh): the build fails
# where ptxas spills in one or serializes its wgmma's (C7515 / C7518)
WGMMA_KERNELS = re.compile(r"wgmma_attention_kernel|prefill_merge_kernel")
# K2 / K2-int8's kernel (csrc/decode_attention.cuh): the build fails where
# ptxas spills in one of its instances
DECODE_KERNELS = re.compile(r"decode_ring_kernel")


def ptxas_report(text: str) -> tuple[list[str], list[str]]:
    """(lines to log, faults) of a build log: each kernel's name, registers,
    spills and any "Performance Loss" line; a fault where a kernel of
    ``WGMMA_KERNELS`` or ``DECODE_KERNELS`` spills, or one of
    ``WGMMA_KERNELS`` has its wgmma's serialized (C7515 / C7518; a warning
    is the entry function's being compiled)."""
    lines, faults, entry, name = [], [], "", ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line
        if "Function properties for" in line:     # the kernel the next two lines describe
            name = line.split("for ")[-1]
            m = re.search(r"\d+([a-z_]*kernel)(I\w*?)?E+[vN]", name)   # template or not
            lines.append(f"  ptxas: {m.group(1) + (m.group(2) or '') if m else name}")
        elif "Used" in line or "spill" in line or "Performance Loss" in line:
            lines.append(f"  ptxas: {line.strip()}")
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if (spills and (WGMMA_KERNELS.search(name) or DECODE_KERNELS.search(name))
                    and spills.groups() != ("0", "0")):
                faults.append(f"{name}: {line.strip()}")
            if ("Performance Loss" in line or re.search(r"C751[58]", line)) and (
                    WGMMA_KERNELS.search(line) or WGMMA_KERNELS.search(entry)):
                faults.append(line.strip())
    return lines, faults


def phase_build():
    from livecc_tpu_torch.ops import build

    t0 = time.perf_counter()
    lib = build.build_library()
    build.load_library()
    log(f"build: {lib} in {time.perf_counter() - t0:.1f} s")
    lines, faults = ptxas_report((lib.parent / "build.log").read_text())
    for line in lines:
        log(line)
    if faults:
        raise AssertionError("build: K2 / K2-int8 spill, or bf16 K1 / K3 spill or serialize "
                             "their wgmma's:\n" + "\n".join(faults))


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

    def decode_replay(label, q, k, v, lim_t, kw, one):
        """K2, or K2-int8 where ``kw`` holds the scales, captured in a CUDA
        graph on layer ``li`` of the stacked cache ``k`` / ``v`` (after an
        eager launch, as the decode graphs do); new kv_limit values are
        written in place (``REPLAY_LIMITS``, then ``lim_t``'s), each
        followed by two replays, which must give an eager launch's bits,
        stay within ``close`` of the plain version on ``one`` (q's layer:
        k, v and the scales or None) and leave the arrival counters zero."""
        from livecc_tpu_torch.ops import flash_attention

        name = "flash_decode_int8" if kw else "flash_decode"
        lim = lim_t.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            flash_decode(q, k, v, lim, layer_index=li, **kw)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = flash_decode(q, k, v, lim, layer_index=li, **kw)
        worst = 0.0
        for limits in (REPLAY_LIMITS, lim_t.tolist()):
            lim.copy_(torch.tensor(limits, dtype=torch.int32))
            replays = []
            for _ in range(2):
                graph.replay()
                replays.append(out.clone())
            eager = flash_decode(q, k, v, lim, layer_index=li, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(r, eager) for r in replays):
                raise AssertionError(f"{name} {label}: a graph replay at {limits} differs from "
                                     f"an eager launch")
            worst = max(worst, kernel_check.close(
                eager, flash_decode_plain(q, *one[:2], lim, *one[2:]), bf16))
            if flash_attention._arrival_counters(dev, 1).any():
                raise AssertionError(f"{name} {label}: the arrival counters are not zero")
        if not worst <= 1.0:
            raise AssertionError(f"{name} {label}: a replay {worst:.3f}x the limit")
        log(f"  {name:20s} {label:48s} graph replays (limits written in place, twice each) "
            f"bit-equal to eager launches, worst {worst:.3f} of the limit, counters zero")
        del graph, out

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
            kt, split, live = kernel_check.split_key_tile(hq, hk, sq, off[row], lim[row], smax,
                                                          qt, b)
            fault = kernel_check.drop_key_tile(ref, q, k5[li], v5[li], off_t, lim_t, qt, kt,
                                               head=5, row=row)
            launched, walking = kernel_check.prefill_blocks(b, hq, hk, sq, off, lim, smax)
            log(f"  {'flash_prefill':20s} {label:48s} grid: {launched} blocks, {walking} walk "
                f"keys; the dropped key tile {kt} is in split {split + 1} of {live}")
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
    decode_replay(label, q, k8, v8, lim_d, dict(k_scale=ks8, v_scale=vs8), layer)
    # p * v_scale kept fp32 (three bf16 parts): the fp32 plain version's roundings
    ref32 = flash_decode_plain(q.float(), *layer[:2], lim_d, *layer[2:])
    flips = kernel_check.rounding_flips(
        flash_decode(q, k8, v8, lim_d, layer_index=li, k_scale=ks8, v_scale=vs8), ref32)
    one_part = kernel_check.rounding_flips(kernel_check.one_part_pv(
        q, *layer[:2], lim_d - 1, lim_d, *layer[2:]).to(bf16), ref32)
    log(f"  {'flash_decode_int8':20s} {label:48s} {flips:.2e} of the outputs round off the fp32 "
        f"plain version's bf16 (limit {kernel_check.FLIP_LIMIT:g}); one bf16 part: {one_part:.3f}")
    if not flips <= kernel_check.FLIP_LIMIT < one_part:
        raise AssertionError(f"flash_decode_int8 {label}: rounding flips {flips}, one part "
                             f"{one_part}, limit {kernel_check.FLIP_LIMIT}")
    del ref32
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
    decode_replay(f"B=8 kv_limit={lim_d.tolist()} bf16", q, k5, v5, lim_d, {},
                  (k5[li], v5[li], None, None))
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
    phase_k4_noncausal(results, randn)
    torch.cuda.empty_cache()
    phase_k4_tp(results, randn)
    torch.cuda.empty_cache()
    phase_k5(results)
    torch.cuda.empty_cache()
    return results


def phase_k4(results, check, times, yardsticks, randn):
    """K4 forward and backward against the plain version at the training
    shape: packed rows of 4096 (bf16, strided q), 1000 (fp32) and 8192
    (bf16, timed, with the bound and the library call on the same inputs);
    then the one-segment yardstick against SDPA's causal kernel and the
    blocked plain versions (fwd, bwd and fwd+bwd at 8192; fwd and bwd alone
    at ``K4_LONG_S``).

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
    (``graph_ms``). The one-segment yardstick's forward is held to the
    blocked plain version (``kernel_check.train_attention_fwd_blocked``) by
    ``close``, which a dropped tile pair must fail."""
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

    # the one-segment yardstick: K4 and SDPA's causal kernel, fwd and fwd+bwd;
    # the forward held to the blocked plain version in its dtypes (o bf16,
    # lse fp32) by close, which must fail a dropped tile pair (key tile 7 of
    # query tile 15: rows of ~1000 keys, so one tile moves them past the limit)
    s = K4_CASES[-1][0]
    qs, k, v, do = inputs(s, torch.bfloat16, False)
    seg = segment_ids(s, (s,), dev)
    fwd = cuda_ms(lambda: train_attention_fwd(qs, k, v, seg))
    o, lse = train_attention_fwd(qs, k, v, seg)
    ro, rlse = kernel_check.train_attention_fwd_blocked(qs, k, v, seg)
    fault = kernel_check.dropped_fwd_tile(qs, k, v, seg, ro, rlse, 15, 7, 3)
    torch.cuda.synchronize()
    label = f"one segment S={s} bf16"
    for part, out, ref, bad, tol in (("o", o, ro, fault[0], torch.bfloat16),
                                     ("lse", lse, rlse, fault[1], torch.float32)):
        w, w_bad = kernel_check.close(out, ref, tol), kernel_check.close(bad, ref, tol)
        err = (out.float() - ref.float()).abs().max().item()
        log(f"  {'train_attention_fwd':20s} {label} {part}: max_abs_err {err:.3e}, worst {w:.3f} "
            f"of the limit (close {kernel_check.TOL[tol]} against the blocked plain version); a "
            f"dropped tile pair: {w_bad:.1f}x")
        if not w <= 1.0:
            raise AssertionError(f"train_attention_fwd {label} {part}: {w:.3f}x the limit")
        if not w_bad > 1.0:
            raise AssertionError(f"train_attention_fwd {label} {part}: the check passes a dropped "
                                 f"tile")
        if part == "o":
            r = results["train_attention_fwd"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
    del ro, rlse, fault
    torch.cuda.empty_cache()
    bwd = cuda_ms(lambda: train_attention_bwd(qs, k, v, seg, o, lse, do))
    both = fwd + bwd
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (qs, k, v, do))
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=1.0,
                                                             enable_gqa=True))
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]

    def lib_both():
        out = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=1.0, enable_gqa=True)
        torch.autograd.grad(out, leaves, dot)

    lib = cuda_ms(lib_both)
    lib_bwd = cuda_ms(sdpa_eval(qs, k, v, True, do))
    plain = (cuda_ms(lambda: kernel_check.train_attention_fwd_blocked(qs, k, v, seg), iters=3,
                     warmup=1),
             cuda_ms(lambda: kernel_check.train_attention_bwd_blocked(qs, k, v, seg, o, lse, do),
                     iters=3, warmup=1))
    flops = 4 * (s * (s + 1) // 2) * d * hq
    log(f"  {'train_attention':20s} one segment S={s}: K4 fwd {fwd:.3f} ms, bwd {bwd:.3f} ms, "
        f"fwd+bwd {both:.3f} ms; SDPA causal fwd {lib_fwd:.3f} ms, bwd {lib_bwd:.3f} ms, fwd+bwd "
        f"{lib:.3f} ms; blocked plain fwd {plain[0]:.3f} ms, bwd {plain[1]:.3f} ms; bound fwd "
        f"{flops / PEAK_FLOPS * 1e3:.4f} ms, bwd {2.5 * flops / PEAK_FLOPS * 1e3:.4f} ms, "
        f"fwd+bwd {3.5 * flops / PEAK_FLOPS * 1e3:.4f} ms")
    results["train_attention_fwd"]["one_segment"] = {"ms": fwd, "library_ms": lib_fwd,
                                                     "plain_ms": plain[0]}
    results["train_attention_bwd"]["one_segment"] = {"ms": bwd, "library_ms": lib_bwd,
                                                     "plain_ms": plain[1], "fwd_bwd_ms": both,
                                                     "library_fwd_bwd_ms": lib}
    del qs, k, v, do, o, lse, qt, kt, vt, dot, leaves
    torch.cuda.empty_cache()

    # and forward and backward alone at one segment of 32768 (the eval and
    # train_cli rows' bucket; held at those rows by phase_eval and
    # phase_train_cli)
    s = K4_LONG_S
    qs, k, v, do = inputs(s, torch.bfloat16, False)
    seg = segment_ids(s, (s,), dev)
    qt, kt, vt = (x.transpose(1, 2) for x in (qs, k, v))

    def fwd_fn():
        return train_attention_fwd(qs, k, v, seg)

    r = {"ms": cuda_ms(fwd_fn), "graph_ms": graph_ms(fwd_fn),
         "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=True, scale=1.0, enable_gqa=True)),
         "plain_ms": cuda_ms(lambda: kernel_check.train_attention_fwd_blocked(qs, k, v, seg),
                             iters=3, warmup=1)}
    flops = 4 * (s * (s + 1) // 2) * d * hq
    io = 2 * (2 * s * hq * d + 2 * s * hk * d)              # q, o, k, v in bf16
    r["bound_ms"], r["bound_by"] = bound(flops, io)
    log(f"  {'train_attention_fwd':20s} one segment S={s}: K4 one call {r['ms']:.3f} ms, device "
        f"{r['graph_ms']:.3f} ms; SDPA causal {r['library_ms']:.3f} ms; blocked plain "
        f"{r['plain_ms']:.3f} ms; bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
        f"{flops / 1e12:.3f} TFLOP)")
    results["train_attention_fwd"]["one_segment_long"] = r
    o, lse = fwd_fn()
    del qt, kt, vt, fwd_fn
    torch.cuda.empty_cache()

    def bwd_fn():
        return train_attention_bwd(qs, k, v, seg, o, lse, do)

    r = {"ms": cuda_ms(bwd_fn), "graph_ms": graph_ms(bwd_fn),
         "library_ms": cuda_ms(sdpa_eval(qs, k, v, True, do)),
         "plain_ms": cuda_ms(lambda: kernel_check.train_attention_bwd_blocked(
             qs, k, v, seg, o, lse, do), iters=3, warmup=1)}
    r["bound_ms"], r["bound_by"] = bound(2.5 * flops, io + 2 * s * hq * d + 3 * (2 * s * hk * d)
                                         + 4 * s * hq + 4 * s)
    log(f"  {'train_attention_bwd':20s} one segment S={s}: K4 one call {r['ms']:.3f} ms, device "
        f"{r['graph_ms']:.3f} ms; SDPA causal backward {r['library_ms']:.3f} ms; blocked plain "
        f"{r['plain_ms']:.3f} ms; bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
        f"{2.5 * flops / 1e12:.3f} TFLOP)")
    results["train_attention_bwd"]["one_segment_long"] = r
    del qs, k, v, do, o, lse, bwd_fn
    torch.cuda.empty_cache()


def phase_k4_noncausal(results, randn):
    """K4's non-causal form (``causal=False``: splash's ``FullMask`` with
    segment ids, on no training path) at ``K4_CASES``' shapes against its
    plain version on the same inputs in the same dtype: o and lse by
    ``kernel_check.close``; fp32 gradients by ``close`` and bf16 ones by
    ``kernel_check.grad_close`` against the fp32 plain version. Each check
    must fail the planted fault ``kernel_check.causal_walk`` (the causal
    form's walk and mask kept under ``causal=False``), and two bf16 launches
    must be bit-equal. At the timed shape: kernel, plain version and SDPA
    with the segment block mask alone (``sdpa_packed(causal=False)``), one
    call each (``cuda_ms``), beside the bound over every within-segment
    pair (the pad segment's included). The numbers go under the
    ``train_attention_fwd`` / ``train_attention_bwd`` entries' key
    ``noncausal`` of the kernels line: one kernel, one launch count, the
    form a template flag."""
    import torch

    from livecc_tpu_torch.ops.attention import prescaled
    from livecc_tpu_torch.ops.train_attention import (
        train_attention_bwd, train_attention_bwd_plain, train_attention_fwd,
        train_attention_fwd_plain)
    from livecc_tpu_torch.tools import kernel_check
    from livecc_tpu_torch.tools.kernel_timing import cuda_ms

    dev = torch.device("cuda")
    hq, hk, d = K4_HEADS
    for i, (s, lengths, kind, strided) in enumerate(K4_CASES):
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        q = randn((1, hq, s, d), dtype).transpose(1, 2) if strided else randn((1, s, hq, d), dtype)
        qs, k, v, do = prescaled(q), *(randn((1, s, h, d), dtype) for h in (hk, hk, hq))
        seg = segment_ids(s, lengths, dev)
        label = f"S={s} segments {list(lengths)} {kind}{' strided q' if strided else ''} non-causal"
        o, lse = train_attention_fwd(qs, k, v, seg, causal=False)
        grads = train_attention_bwd(qs, k, v, seg, o, lse, do, causal=False)
        ro, rlse = train_attention_fwd_plain(qs, k, v, seg, causal=False)
        rgrads = train_attention_bwd_plain(qs, k, v, seg, o, lse, do, causal=False)
        fault = kernel_check.causal_walk(qs, k, v, seg, do, o, lse)
        if kind == "bf16":
            f32 = [x.float() for x in (qs, k, v)]
            r32 = train_attention_bwd_plain(*f32, seg, *train_attention_fwd_plain(
                *f32, seg, causal=False), do.float(), causal=False)
            del f32
        torch.cuda.synchronize()
        for j, (part, out, ref, bad) in enumerate(zip(("o", "lse", "dq", "dk", "dv"),
                                                      (o, lse, *grads), (ro, rlse, *rgrads),
                                                      fault)):
            name = "train_attention_fwd" if j < 2 else "train_attention_bwd"
            if kind == "bf16" and j >= 2:
                w, w_bad = (kernel_check.grad_close(x, ref, r32[j - 2]) for x in (out, bad))
                limit = "grad_close against the fp32 plain version"
            else:
                tol = torch.float32 if part == "lse" else dtype
                w, w_bad = (kernel_check.close(x, ref, tol) for x in (out, bad))
                limit = f"close {kernel_check.TOL[tol]}"
            err = (out.float() - ref.float()).abs().max().item()
            log(f"  {name:20s} {label} {part}: max_abs_err {err:.3e}, worst {w:.3f} of the "
                f"limit ({limit}); the causal walk: {w_bad:.1f}x")
            if not w <= 1.0:
                raise AssertionError(f"{name} {label} {part}: {w:.3f}x the limit")
            if not w_bad > 1.0:
                raise AssertionError(f"{name} {label} {part}: the check passes the causal walk")
            if part != "lse":
                r = results[name].setdefault("noncausal", {"max_abs_err": 0.0})
                r["max_abs_err"] = max(r["max_abs_err"], err)
        del rgrads, fault
        if kind == "bf16":
            del r32
            again = (*train_attention_fwd(qs, k, v, seg, causal=False),
                     *train_attention_bwd(qs, k, v, seg, o, lse, do, causal=False))
            if not all(torch.equal(a, b) for a, b in zip((o, lse, *grads), again)):
                raise AssertionError(f"train_attention {label}: two launches differ")
            log(f"  {'train_attention':20s} {label}: two launches bit-equal (o, lse, dq, dk, dv)")
            del again
        del ro, rlse
        torch.cuda.empty_cache()
        if i == len(K4_CASES) - 1:          # timed
            pairs = sum(n * n for n in (*lengths, s - sum(lengths)))
            io = 2 * (2 * s * hq * d + 2 * s * hk * d)          # q, o, k, v in bf16
            work = {"train_attention_fwd": (4 * pairs * d * hq, io + 4 * s * hq + 4 * s),
                    "train_attention_bwd": (10 * pairs * d * hq, io + 2 * s * hq * d
                                            + 3 * (2 * s * hk * d) + 4 * s * hq + 4 * s)}
            fns = {"train_attention_fwd": (
                       lambda: train_attention_fwd(qs, k, v, seg, causal=False),
                       lambda: train_attention_fwd_plain(qs, k, v, seg, causal=False),
                       sdpa_packed(qs, k, v, seg, None, causal=False)),
                   "train_attention_bwd": (
                       lambda: train_attention_bwd(qs, k, v, seg, o, lse, do, causal=False),
                       lambda: train_attention_bwd_plain(qs, k, v, seg, o, lse, do, causal=False),
                       sdpa_packed(qs, k, v, seg, do, causal=False))}
            for name, (kernel_fn, plain_fn, library_fn) in fns.items():
                r = results[name]["noncausal"]
                r["ms"], r["plain_ms"], r["library_ms"] = (cuda_ms(fn) for fn in
                                                           (kernel_fn, plain_fn, library_fn))
                r["bound_ms"], r["bound_by"] = bound(*work[name])
                log(f"  {name:20s} {label}: kernel {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  "
                    f"SDPA {r['library_ms']:.3f} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
                    f"{work[name][0] / 1e9:.3f} GFLOP)")
            del fns
        del qs, k, v, do, o, lse, grads
        torch.cuda.empty_cache()


def phase_k4_tp(results, randn):
    """K4 at one tensor-parallel rank's heads of the 7B (``K4_TP_HEADS``:
    Hq = 14, Hk = 2 for M = 2; Hq = 7, Hk = 1 for M = 4) on the packed rows
    of ``K4_CASES``' timed case (S = 8192, bf16), forward and backward,
    against the plain version on the same inputs: o and lse by
    ``kernel_check.close`` in their dtypes, the gradients by
    ``kernel_check.grad_close`` against the fp32 plain version; each check
    must fail the reference with one tile pair dropped
    (``kernel_check.dropped_tile``). Kernel, plain version and SDPA
    (``sdpa_packed``), one call each (``cuda_ms``), beside the bound. The
    numbers go under the K4 entries' key ``tp`` of the kernels line,
    keyed by M."""
    import torch

    from livecc_tpu_torch.ops.attention import prescaled
    from livecc_tpu_torch.ops.train_attention import (
        train_attention_bwd, train_attention_bwd_plain, train_attention_fwd,
        train_attention_fwd_plain)
    from livecc_tpu_torch.tools import kernel_check
    from livecc_tpu_torch.tools.kernel_timing import cuda_ms

    dev = torch.device("cuda")
    s, lengths, _, _ = K4_CASES[-1]
    d = K4_HEADS[2]
    bf16 = torch.bfloat16
    seg = segment_ids(s, lengths, dev)
    qt = lengths[0] // 64 - 1                        # a query tile at the end of segment 1
    for m, hq, hk in K4_TP_HEADS:
        qs, k, v, do = prescaled(randn((1, s, hq, d), bf16)), *(randn((1, s, h, d), bf16)
                                                              for h in (hk, hk, hq))
        label = f"S={s} segments {list(lengths)} Hq={hq} Hk={hk} bf16 (TP rank of M={m})"
        o, lse = train_attention_fwd(qs, k, v, seg)
        grads = train_attention_bwd(qs, k, v, seg, o, lse, do)
        ro, rlse = train_attention_fwd_plain(qs, k, v, seg)
        rgrads = train_attention_bwd_plain(qs, k, v, seg, o, lse, do)
        f32 = [x.float() for x in (qs, k, v)]
        r32 = train_attention_bwd_plain(*f32, seg, *train_attention_fwd_plain(*f32, seg),
                                        do.float())
        del f32
        fault = (*kernel_check.dropped_tile(qs, k, v, seg, do, ro, rlse, rgrads, qt, qt // 2,
                                            min(3, hq - 1))[:2],
                 *kernel_check.dropped_tile(qs, k, v, seg, do, o, lse, rgrads, qt, qt // 2,
                                            min(3, hq - 1))[2:])
        torch.cuda.synchronize()
        for j, (part, out, ref, bad) in enumerate(zip(("o", "lse", "dq", "dk", "dv"),
                                                      (o, lse, *grads), (ro, rlse, *rgrads),
                                                      fault)):
            name = "train_attention_fwd" if j < 2 else "train_attention_bwd"
            if j >= 2:
                w, w_bad = (kernel_check.grad_close(x, ref, r32[j - 2]) for x in (out, bad))
                limit = "grad_close against the fp32 plain version"
            else:
                tol = torch.float32 if part == "lse" else bf16
                w, w_bad = (kernel_check.close(x, ref, tol) for x in (out, bad))
                limit = f"close {kernel_check.TOL[tol]}"
            err = (out.float() - ref.float()).abs().max().item()
            log(f"  {name:20s} {label} {part}: max_abs_err {err:.3e}, worst {w:.3f} of the "
                f"limit ({limit}); a dropped tile pair: {w_bad:.1f}x")
            if not w <= 1.0:
                raise AssertionError(f"{name} {label} {part}: {w:.3f}x the limit")
            if not w_bad > 1.0:
                raise AssertionError(f"{name} {label} {part}: the check passes a dropped tile")
            if part != "lse":
                r = results[name].setdefault("tp", {}).setdefault(f"M={m}", {"max_abs_err": 0.0})
                r["max_abs_err"] = max(r["max_abs_err"], err)
        del rgrads, r32, fault, ro, rlse
        torch.cuda.empty_cache()
        pairs = causal_pairs(lengths, s)
        io = 2 * (2 * s * hq * d + 2 * s * hk * d)              # q, o, k, v in bf16
        work = {"train_attention_fwd": (4 * pairs * d * hq, io + 4 * s * hq + 4 * s),
                "train_attention_bwd": (10 * pairs * d * hq, io + 2 * s * hq * d
                                        + 3 * (2 * s * hk * d) + 4 * s * hq + 4 * s)}
        fns = {"train_attention_fwd": (lambda: train_attention_fwd(qs, k, v, seg),
                                       lambda: train_attention_fwd_plain(qs, k, v, seg),
                                       sdpa_packed(qs, k, v, seg, None)),
               "train_attention_bwd": (lambda: train_attention_bwd(qs, k, v, seg, o, lse, do),
                                       lambda: train_attention_bwd_plain(qs, k, v, seg, o, lse,
                                                                         do),
                                       sdpa_packed(qs, k, v, seg, do))}
        for name, (kernel_fn, plain_fn, library_fn) in fns.items():
            r = results[name]["tp"][f"M={m}"]
            r["ms"], r["plain_ms"], r["library_ms"] = (cuda_ms(fn) for fn in
                                                       (kernel_fn, plain_fn, library_fn))
            r["bound_ms"], r["bound_by"] = bound(*work[name])
            r["heads"] = [hq, hk]
            log(f"  {name:20s} {label}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.3f} ms  "
                f"SDPA {r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
                f"{work[name][0] / 1e9:.3f} GFLOP)")
        del fns, qs, k, v, do, o, lse, grads
        torch.cuda.empty_cache()


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


# K5 at one TP rank of the 7B: projection -> (N, K, fp32 output) of rank m's
# share (q / k / gate split on N, o / down on K, the vocab rows on N), at
# TP_W8_ROWS tokens (a decode step, a steady chunk)
def tp_w8_proj(m: int) -> dict:
    return {"q_proj": (3584 // m, 3584, False), "k_proj": (512 // m, 3584, False),
            "gate_proj": (18944 // m, 3584, False), "o_proj": (3584, 3584 // m, False),
            "down_proj": (3584, 18944 // m, False), "lm_head": (152064 // m, 3584, True)}


TP_W8_ROWS = (1, 256)


def phase_kernels_tp(results) -> None:
    """The serving kernels at one tensor-parallel rank's shapes of the 7B
    (``K4_TP_HEADS``: Hq = 14, Hk = 2 for M = 2; Hq = 7, Hk = 1 for M = 4),
    the shapes a rank of ``shard_params``' split runs them at: K1 at a
    steady chunk (Sq = 256, offset 1500) and a verify window (Sq = 9) on a
    bf16 cache; K2 at B = 1 (777 keys) and B = 8 (``POOL_LIMITS``); K1-int8
    (Sq = 256 at ``INT8_STEADY_OFFSETS``, and Sq = 9) and K2-int8 (B = 8) on
    the pool's int8 cache ``[28, 8, Hk, 8192, 128]``; K5 on rank m's share
    of q / k / gate (N / M), o / down (K / M) and the fp32 lm_head (V / M)
    at 1 and 256 tokens. Each case is held to its plain version on the
    same inputs by ``kernel_check.close`` in the output's dtype, a limit
    that the planted fault of that kernel must fail (``drop_key_tile``,
    ``drop_split``, ``w8_drop_split`` / ``w8_drop_k_tile``); two launches
    must be bit-equal; kernel, plain version and library call (SDPA, or
    torch.mm on the bf16 weight; none on an int8 cache) are timed one call
    (``cuda_ms``) and on the device (``graph_ms``) beside the bound. The
    numbers go under each entry's ``tp`` key of the kernels line, keyed by
    M: the first case's as the entry's, every case under ``cases``."""
    import torch
    import torch.nn.functional as F

    from livecc_tpu_torch.models.qwen2_vl.text import quantize_kv
    from livecc_tpu_torch.ops import quant
    from livecc_tpu_torch.ops.flash_attention import (
        DECODE_SPLIT, flash_decode, flash_decode_plain, flash_prefill, flash_prefill_plain)
    from livecc_tpu_torch.tools import kernel_check, kernel_timing
    from livecc_tpu_torch.tools.kernel_timing import cuda_ms, graph_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    bf16 = torch.bfloat16
    layers, d, smax, li = 28, 128, 8192, 27

    def randn(shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def case(name, m, label, fns, fault, flops, nbytes, dtype=bf16):
        """One case: held, faulted, repeated, timed; recorded under
        ``results[name]["tp"]["M=m"]``."""
        out, ref, again = fns[0](), fns[1](), fns[0]()
        torch.cuda.synchronize()
        worst, w_bad = kernel_check.close(out, ref, dtype), kernel_check.close(fault, ref, dtype)
        err = (out.float() - ref.float()).abs().max().item()
        if not worst <= 1.0:
            raise AssertionError(f"{name} {label}: {worst:.3f}x the limit")
        if not w_bad > 1.0:
            raise AssertionError(f"{name} {label}: the check passes the planted fault")
        if not torch.equal(out, again):
            raise AssertionError(f"{name} {label}: two launches differ")
        del out, ref, again, fault
        one = [None if fn is None else cuda_ms(fn) for fn in fns]
        dev_t = [None if fn is None else graph_ms(fn) for fn in fns]
        b_ms, b_by = bound(flops, nbytes)
        lib = lambda t: "none" if t is None else f"{t:.4f}"
        log(f"  {name:20s} {label:56s} max_abs_err {err:.3e}, worst {worst:.3f} of the limit "
            f"{kernel_check.TOL[dtype]}; the fault {w_bad:.1f}x; bit-equal; one call: kernel "
            f"{one[0]:.4f}  plain {one[1]:.4f}  library {lib(one[2])} ms; device: kernel "
            f"{dev_t[0]:.4f}  plain {dev_t[1]:.4f}  library {lib(dev_t[2])} ms; bound "
            f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
        r = results[name].setdefault("tp", {}).setdefault(f"M={m}", {"max_abs_err": 0.0,
                                                                     "cases": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        row = {"case": label, "ms": one[0], "plain_ms": one[1], "library_ms": one[2],
               "bound_ms": b_ms, "bound_by": b_by, "device_ms": dev_t[0],
               "device_plain_ms": dev_t[1], "device_library_ms": dev_t[2]}
        r["cases"].append(row)
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
            r.setdefault(key, row[key])

    def int8_cache(shape):
        codes, scale = quantize_kv(randn(shape))
        return codes, scale.transpose(-1, -2).contiguous()

    for m, hq, hk in K4_TP_HEADS:
        heads = f"Hq={hq} Hk={hk} (M={m})"
        # K1 / K2 on a bf16 cache
        for b in (1, 8):
            k, v = (randn((layers, b, hk, smax, d)) for _ in range(2))
            if b == 1:
                for sq in (256, kernel_timing.WINDOW_SQ):
                    q = randn((1, sq, hq, d)).transpose(1, 2)
                    off, lim = 1500, 1500 + sq
                    off_t, lim_t = (torch.tensor([x], dtype=torch.int32, device=dev)
                                    for x in (off, lim))
                    kq, vq = k[li][:, :, :lim], v[li][:, :, :lim]
                    mask = (torch.arange(lim, device=dev)[None, :]
                            <= off + torch.arange(sq, device=dev)[:, None])
                    fns = (lambda: flash_prefill(q, k, v, off_t, lim_t, layer_index=li),
                           lambda: flash_prefill_plain(q, k[li], v[li], off_t, lim_t),
                           lambda: F.scaled_dot_product_attention(q, kq, vq, attn_mask=mask,
                                                                  enable_gqa=True))
                    qt = (sq - 1) // 64
                    kt, split, live = kernel_check.split_key_tile(hq, hk, sq, off, lim, smax, qt)
                    fault = kernel_check.drop_key_tile(fns[1](), q, k[li], v[li], off_t, lim_t,
                                                       qt, kt, head=hq - 1)
                    pairs = sum(off + i + 1 for i in range(sq))
                    case("flash_prefill", m, f"B=1 Sq={sq} offset={off} {heads} bf16 (the "
                         f"fault in split {split + 1} of {live})", fns, fault,
                         4 * pairs * d * hq, 2 * q.numel() * 2 + 2 * hk * lim * d * 2)
            lims = [777] if b == 1 else kernel_timing.POOL_LIMITS
            q = randn((b, 1, hq, d)).transpose(1, 2)
            lim_t = torch.tensor(lims, dtype=torch.int32, device=dev)
            valid = (torch.arange(smax, device=dev)[None, :] < lim_t[:, None])[:, None, None]
            fns = (lambda: flash_decode(q, k, v, lim_t, layer_index=li),
                   lambda: flash_decode_plain(q, k[li], v[li], lim_t),
                   lambda: F.scaled_dot_product_attention(q, k[li], v[li], attn_mask=valid,
                                                          enable_gqa=True))
            fault = kernel_check.drop_split(q, k[li], v[li], lim_t, DECODE_SPLIT)
            case("flash_decode", m, f"B={b} kv_limit={lims} {heads} bf16", fns, fault,
                 4 * sum(lims) * d * hq, 2 * q.numel() * 2 + 2 * hk * sum(lims) * d * 2)
            del k, v
            torch.cuda.empty_cache()
        # K1-int8 / K2-int8 on the pool's int8 cache
        b = 8
        (k8, ks8), (v8, vs8) = (int8_cache((layers, b, hk, smax, d)) for _ in range(2))
        one = (k8[li], v8[li], ks8[li], vs8[li])
        offs = kernel_timing.INT8_STEADY_OFFSETS
        for sq in (kernel_timing.INT8_SQ, kernel_timing.WINDOW_SQ):
            q = randn((b, sq, hq, d)).transpose(1, 2)
            lims = [o + sq for o in offs]
            off_t, lim_t = (torch.tensor(x, dtype=torch.int32, device=dev) for x in (offs, lims))
            fns = (lambda: flash_prefill(q, k8, v8, off_t, lim_t, layer_index=li, k_scale=ks8,
                                         v_scale=vs8),
                   lambda: flash_prefill_plain(q, *one[:2], off_t, lim_t, *one[2:]), None)
            row = max(range(b), key=lambda i: lims[i])
            qt = (sq - 1) // 64
            fault = kernel_check.drop_key_tile(fns[1](), q, *one[:2], off_t, lim_t, qt,
                                               (offs[row] + 64 * qt + 1) // 64 // 2,
                                               head=hq - 1, row=row, k_scale=one[2],
                                               v_scale=one[3])
            pairs = sum(sq * o + sq * (sq + 1) // 2 for o in offs)
            case("flash_prefill_int8", m, f"B=8 Sq={sq} offsets={list(offs)} {heads} bf16", fns,
                 fault, 4 * pairs * d * hq, 2 * q.numel() * 2 + 2 * hk * sum(lims) * (d + 2))
        lims = kernel_timing.POOL_LIMITS
        q = randn((b, 1, hq, d)).transpose(1, 2)
        lim_t = torch.tensor(lims, dtype=torch.int32, device=dev)
        fns = (lambda: flash_decode(q, k8, v8, lim_t, layer_index=li, k_scale=ks8, v_scale=vs8),
               lambda: flash_decode_plain(q, *one[:2], lim_t, *one[2:]), None)
        fault = kernel_check.drop_split(q, *one[:2], lim_t, DECODE_SPLIT, *one[2:])
        case("flash_decode_int8", m, f"B=8 kv_limit={lims} {heads} bf16", fns, fault,
             4 * sum(lims) * d * hq, 2 * q.numel() * 2 + 2 * hk * sum(lims) * (d + 2))
        del k8, v8, ks8, vs8, one
        torch.cuda.empty_cache()
        # K5 on rank m's share of each projection
        reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        try:
            for proj, (n, kk, fp32_out) in tp_w8_proj(m).items():
                node = quant.quantize_weight(randn((n, kk)) * kk ** -0.5, scale_axis=-1)
                wq, scale = node["q"], node["scale"].reshape(-1)
                w = wq.to(bf16) * scale[:, None]
                out_dtype = torch.float32 if fp32_out else None
                for rows in TP_W8_ROWS:
                    x = randn((rows, kk))
                    fault = (kernel_check.w8_drop_split(x, wq, scale, out_dtype)
                             if rows <= quant.SMALL_M else
                             kernel_check.w8_drop_k_tile(x, wq, scale, out_dtype))
                    fns = (lambda: quant.w8a16_gemm(x, wq, scale, out_dtype),
                           lambda: quant.w8a16_gemm_plain(x, wq, scale, out_dtype),
                           (lambda: torch.mm(x, w.t())) if out_dtype is None
                           else (lambda: torch.mm(x, w.t(), out_dtype=out_dtype)))
                    case("w8a16_gemm", m, f"{proj} M={rows} N={n} K={kk} "
                         f"{'fp32' if fp32_out else 'bf16'} out (TP M={m})", fns, fault,
                         *kernel_timing.w8_work(rows, n, kk, fp32_out), out_dtype or bf16)
                del node, wq, scale, w
        finally:
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
        torch.cuda.empty_cache()

def sdpa_packed(qs, k, v, seg, do, causal=True):
    """The one PyTorch call that computes K4's function on these inputs:
    SDPA with the packed rows' block-causal mask (the segment block mask
    alone when not ``causal``) and GQA (forward, or with ``do`` the backward
    of a forward made outside the timing)."""
    import torch
    import torch.nn.functional as F

    s = qs.shape[1]
    pos = torch.arange(s, device=qs.device)
    mask = seg[0][:, None] == seg[0][None, :]
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])
    mask = mask[None, None]
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
    tokens of each decode, "chunks": its chunk walls, "logits": its last
    prefill's logits, "kv": its cache's K + V bytes, rows and length}."""
    import torch

    from livecc_tpu_torch.engine.generation import DecodeState
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import session
    from livecc_tpu_torch.tools.layer_costs import step_replay_ms

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
    cache = state.cache
    return counts, record, dict(prof, step_ms=step_ms, tokens=[t for t, *_ in record],
                                chunks=[c.seconds for c in eng.chunk_log], logits=state.logits,
                                kv={"bytes": cache.k.nbytes + cache.v.nbytes,
                                    "rows": cache.k.shape[1], "len": cache.max_len})


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
    tick's, "kv": the pool cache's K + V bytes, scale bytes, rows and
    length}."""
    import torch

    from livecc_tpu_torch.engine.generation import DecodeState
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import session
    from livecc_tpu_torch.tools.layer_costs import step_replay_ms

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
    return counts, record, dict(prof, step_ms=step_ms, ticks=walls,
                                kv={"bytes": pool.k.nbytes + pool.v.nbytes,
                                    "scales": pool.k_scale.nbytes + pool.v_scale.nbytes,
                                    "rows": pool.k.shape[1], "len": pool.max_len})


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
    from livecc_tpu_torch.tools.layer_costs import step_replay_ms

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
    from livecc_tpu_torch.tools.layer_costs import step_replay_ms

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


def phase_pool_w8(cfg, model, pool: dict) -> tuple[dict, list, dict]:
    """JAX's TPU serving configuration: ``pool``'s 8 streams on the 7B with
    int8 weights and the int8 KV cache, through the decode graphs and the
    eager plain loop (``pool_phase``: identical tokens, K5 launched). Prints
    the steady ticks, the profiled tick's busy time and one B = 8 decode-step
    replay beside ``pool``'s. Returns ``pool_phase``'s launch counts, record
    and summary."""
    counts, record, w8 = pool_phase("pool_w8", cfg, model, POOL_W8_KERNELS)
    ticks = lambda d: ", ".join(f"{t * 1e3:.1f}" for t in d["ticks"][1:])
    log(f"  pool_w8 against pool (bf16 weights): steady ticks {ticks(w8)} against {ticks(pool)} "
        f"ms; profiled steady tick wall {w8['wall'] * 1e3:.1f} against {pool['wall'] * 1e3:.1f} "
        f"ms, device busy {w8['busy'] * 1e3:.1f} against {pool['busy'] * 1e3:.1f} ms; decode "
        f"step replay B=8 {w8['step_ms']:.3f} against {pool['step_ms']:.3f} ms "
        f"({w8['step_ms'] / pool['step_ms']:.3f}x)")
    return counts, record, w8


@contextlib.contextmanager
def torchrun_vars():
    """torchrun's variables for a world of one started in this process (a
    free localhost port), restored after."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def counted_collectives(issued):
    """Count each all-reduce and all-gather the port issues by (name, whether
    a CUDA graph capture was under way)."""
    import torch
    import torch.distributed as dist

    saved = {name: getattr(dist, name) for name in ("all_reduce", "all_gather_into_tensor")}

    def counted(name, fn):
        def run(*args, **kw):
            issued[(name, torch.cuda.is_current_stream_capturing())] += 1
            return fn(*args, **kw)
        return run

    for name, fn in saved.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def unsplit(model) -> None:
    """Take a tower split at M = 1 off its model group (its tensors are whole)."""
    model.text.tp = None
    for layer in model.text.layers:
        layer.tp = None


def tp_storage(cfg) -> dict:
    """One rank's ``shard_params`` of a fresh bf16 7B at M = 2 and 4 (rank 0's
    slices; no collective, so one card shows what each rank keeps): the
    allocated bytes before and after and the peak while it slices. Fails
    unless every split tensor owns storage of its shard's size, the rank's
    weights are the replicated tensors plus 1 / M of the split ones, and
    the allocator freed at least 99% of the split tensors' (1 - 1 / M)
    (its blocks round the sizes). Returns {M: the rank's weight bytes}."""
    import torch

    from livecc_tpu_torch.core.mesh import Mesh
    from livecc_tpu_torch.parallel.sharding import shard_params, split_dim
    from livecc_tpu_torch.tools import session

    rank_bytes = {}
    for m in (2, 4):
        _, fresh = session.main_model()
        total = session.model_bytes(fresh)
        split = sum(p.numel() * p.element_size() for n, p in fresh.named_parameters()
                    if split_dim(n) is not None)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        shard_params(fresh, cfg, Mesh(1, m, 0, None, None, torch.device("cuda")))
        torch.cuda.synchronize()
        after, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
        weights = session.model_bytes(fresh)
        want = split - split // m
        whole = [n for n, p in fresh.named_parameters() if split_dim(n) is not None
                 and p.untyped_storage().nbytes() != p.numel() * p.element_size()]
        log(f"  shard_params of the bf16 7B at M={m}, rank 0: allocated {before / 2**30:.2f} -> "
            f"{after / 2**30:.2f} GiB (freed {(before - after) / 2**30:.3f} GiB; the split "
            f"tensors' (1 - 1/M) {want / 2**30:.3f} GiB), peak while slicing "
            f"{peak / 2**30:.2f} GiB; the rank's weights {weights / 2**30:.3f} GiB")
        if whole or weights != total - want or not before - after >= 0.99 * want:
            raise AssertionError(f"tp_serve: shard_params at M={m}: weights {weights} of "
                                 f"{total - want}, freed {before - after} of {want}, "
                                 f"whole storages {whole[:4]}")
        rank_bytes[m] = weights
        del fresh
        gc.collect()
        torch.cuda.empty_cache()
    return rank_bytes


def phase_tp_serve(cfg, models, main_record: list, main: dict, pool_record: list,
                   pool: dict) -> dict:
    """Tensor-parallel serving (``phase_tp_serve``): first the storage of
    ``shard_params`` at M = 2 and 4 (``tp_storage``). Then, with torchrun's
    variables set in the process, ``init_mesh("1x1", "cuda")`` over NCCL and
    ``shard_params`` on main's bf16 7B and on pool_w8's int8 one (M = 1:
    nothing is sliced, every collective of the split tower is issued):
    main's single-stream session (bf16 KV of 8192, the 6-frame chunk and
    the steady ones) and pool_w8's int8-KV pool (8 streams, the warmup and
    every tick), each through the decode graphs. Checks: tokens identical
    to main's and pool_w8's runs without a mesh (their eager plain loops'
    records, which equal their graph runs); the last prefill's logits
    compared with main's (bit-equal expected at M = 1; the difference is
    printed); every kernel of ``MAIN_KERNELS`` / ``POOL_W8_KERNELS``
    launched; decode-graph replays; all-reduces and all-gathers issued
    inside the captures. Prints chunk and tick walls beside the no-mesh
    runs', each rank's weight and KV bytes, and one steady chunk under the
    profiler (replays, collectives, NCCL kernels, busy and idle share).
    Where the machine has 2 or 4 cards, the same sessions at 1x2 / 1x4
    through torchrun (this script's ``--tp-worker`` mode), held to the
    no-mesh tokens up to each stream's first near-tie parting
    (``near_ties``); it prints the world sizes it ran. Returns the 1x1
    runs' launch counts and ``tp_storage``'s rank bytes."""
    import collections

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from livecc_tpu_torch.core.mesh import close_mesh, init_mesh
    from livecc_tpu_torch.engine.generation import DecodeState, GenerationParams
    from livecc_tpu_torch.engine.graphs import graphs_for
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.parallel.sharding import shard_params
    from livecc_tpu_torch.parallel.tp import reduce_from_model
    from livecc_tpu_torch.tools import session
    from livecc_tpu_torch.tools.kernel_timing import cuda_ms
    from livecc_tpu_torch.tools.layer_costs import step_replay_ms
    from livecc_tpu_torch.tools.profile_stream import busy_seconds

    rank_bytes = tp_storage(cfg)
    model, model_w8 = models
    issued: collections.Counter = collections.Counter()
    counts: collections.Counter = collections.Counter()
    frames = session.main_frames()
    with torchrun_vars(), counted_collectives(issued):
        mesh = init_mesh("1x1", "cuda")
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"tp_serve: backend {dist.get_backend()}")
            for mod in models:
                shard_params(mod, cfg, mesh)
            torch.cuda.synchronize()
            log(f"  init_mesh('1x1', 'cuda') over {dist.get_backend()}; the rank's weights: "
                f"bf16 7B {session.model_bytes(model) / 2**30:.3f} GiB, int8 7B "
                f"{session.model_bytes(model_w8) / 2**30:.3f} GiB; allocated "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
            # main's session
            graphs = graphs_for(model, cfg)
            graphs.reset_stats()
            record: list = []
            build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with decoding(False, record):
                eng = session.new_engine(cfg, model)
                state = eng.new_stream()
                out = session.run_session(eng, frames, state=state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = dict(build.launch_counts)
            counts.update(got)
            stats = graphs.stats()
            walls = ", ".join(f"{c.seconds * 1e3:.1f}" for c in eng.chunk_log)
            log(f"  main at 1x1: wall {wall:.3f} s (chunks {walls} ms; no mesh: "
                f"{', '.join(f'{s * 1e3:.1f}' for s in main['chunks'])} ms), {stats['captures']} "
                f"captures, {stats['replays']} replays; launches {got}; KV "
                f"{(state.cache.k.nbytes + state.cache.v.nbytes) / 2**30:.3f} GiB "
                f"(bf16, {state.cache.max_len} positions, {state.cache.k.shape[2]} KV heads)")
            same_tokens("tp_serve main", record, main_record, "the 1x1 mesh and the no-mesh run")
            diff = (state.logits - main["logits"]).abs().max().item()
            log(f"  main at 1x1: the last prefill's logits "
                + ("bit-equal to the no-mesh run's" if torch.equal(state.logits, main["logits"])
                   else f"differ from the no-mesh run's by up to {diff:.3e}"))
            missing = [k for k in MAIN_KERNELS if got.get(k, 0) <= 0]
            if missing or stats["replays"] <= 0:
                raise AssertionError(f"tp_serve main: never launched {missing}, or "
                                     f"{stats['replays']} replays")
            # one steady chunk under the profiler
            before = dict(issued)
            graphs.reset_stats()
            gen = GenerationParams(max_new_tokens=session.NEW_TOKENS,
                                   eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
                                   repetition_penalty=session.REPETITION_PENALTY)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng.chunk_step(state, frames[-2:], 7.0, 8.0, None, gen)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            events = prof.events()
            colls = collections.Counter(e.name for e in events if e.device_type ==
                                        torch.autograd.DeviceType.CPU
                                        and e.name.startswith("c10d::"))
            nccl = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.name.lower().startswith("nccl")]
            busy = busy_seconds(prof)
            host = sum(e.cpu_time_total for e in events if e.device_type ==
                       torch.autograd.DeviceType.CPU and e.name.startswith("c10d::")) / 1e3
            eager = {k[0]: v - before.get(k, 0) for k, v in issued.items() if not k[1]}
            log(f"  one steady chunk profiled: wall {wall:.3f} s, device busy {busy:.3f} s, idle "
                f"share {1 - busy / wall:.3f}; {graphs.stats()['replays']} decode-step replays, "
                f"each replaying the all-reduces and the all-gather captured into it; eager "
                f"collectives (prefill) {eager}, c10d ranges {dict(colls)} holding "
                f"{host:.2f} ms of host time; NCCL kernels {len(nccl)} "
                f"{sorted({e.name for e in nccl})}")
            step_ms = step_replay_ms(model, state.cache, DecodeState)
            x = torch.randn((1, 256, cfg.text.hidden_size), device="cuda").bfloat16()
            tp = model.text.tp
            eager_ms = [cuda_ms(lambda: [fn(x) for _ in range(57)]) for fn in (
                lambda y: reduce_from_model(y, tp), lambda y: y.contiguous().clone())]
            log(f"  main at 1x1: decode step replay {step_ms:.3f} ms device time (no mesh "
                f"{main['step_ms']:.3f} ms); a prefill's 57 all-reduces of [1, 256, "
                f"{cfg.text.hidden_size}] bf16, eagerly: {eager_ms[0]:.3f} ms (57 clones alone "
                f"{eager_ms[1]:.3f} ms; one call, host included)")
            del prof, events, eng, state, x
            # pool_w8's pool
            graphs = graphs_for(model_w8, cfg)
            graphs.reset_stats()
            record = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with decoding(False, record):
                server = session.pool_server(cfg, model_w8)
                server.warmup([(session.HEIGHT, session.WIDTH)])
                build.reset_launch_counts()
                _, ticks = session.run_pool(server)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = dict(build.launch_counts)
            counts.update(got)
            stats = graphs.stats()
            kv = server.pool_caches
            log(f"  pool_w8 at 1x1: wall {wall:.3f} s (ticks "
                f"{', '.join(f'{t * 1e3:.1f}' for t in ticks)} ms; no mesh: "
                f"{', '.join(f'{t * 1e3:.1f}' for t in pool['ticks'])} ms), {stats['captures']} "
                f"captures, {stats['replays']} replays; launches {got}; KV "
                f"{(kv.k.nbytes + kv.v.nbytes) / 2**30:.3f} GiB int8 + "
                f"{(kv.k_scale.nbytes + kv.v_scale.nbytes) / 2**20:.1f} MiB scales "
                f"({kv.k.shape[2]} KV heads)")
            same_tokens("tp_serve pool_w8", record, pool_record,
                        "the 1x1 mesh and the no-mesh run")
            missing = [k for k in POOL_W8_KERNELS if got.get(k, 0) <= 0]
            if missing or stats["replays"] <= 0:
                raise AssertionError(f"tp_serve pool_w8: never launched {missing}, or "
                                     f"{stats['replays']} replays")
            stream_of = pool_streams(server)
            del server, kv
        finally:
            close_mesh(mesh)
            for mod in models:
                unsplit(mod)
    captured = {k[0]: v for k, v in issued.items() if k[1]}
    log(f"  collectives issued inside the decode graphs' captures: {captured}; eagerly: "
        f"{ {k[0]: v for k, v in issued.items() if not k[1]} }")
    if not all(captured.get(k, 0) > 0 for k in ("all_reduce", "all_gather_into_tensor")):
        raise AssertionError(f"tp_serve: no collective captured into a decode graph ({issued})")
    gc.collect()
    torch.cuda.empty_cache()

    worlds = [1]
    n_cards = torch.cuda.device_count()
    for n in (2, 4):
        if n > n_cards:
            continue
        path = os.path.join(ROOT, "build", f"tp_serve_1x{n}.pt")
        done = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc_per_node", str(n), os.path.abspath(__file__),
                               "--tp-worker", json.dumps({"out": path})],
                              capture_output=True, text=True, timeout=600)
        if done.returncode != 0:
            raise AssertionError(f"tp_serve 1x{n}: torchrun exited {done.returncode}: "
                                 f"{(done.stdout + done.stderr)[-3000:]}")
        other = torch.load(path)
        os.remove(path)
        near_ties(f"tp_serve 1x{n} main", [(t, g, None) for t, g in other["main"]], main_record,
                  lambda d, r: 0)
        near_ties(f"tp_serve 1x{n} pool_w8", [(t, g, None) for t, g in other["pool"]],
                  pool_record, stream_of)
        worlds.append(n)
    log(f"  world sizes run: {worlds} ({n_cards} card(s) here; the multi-rank parity comes "
        f"from the CPU tests over gloo)")
    return dict(counts), rank_bytes


def tp_worker(spec: str) -> int:
    """One rank of ``phase_tp_serve``'s multi-card runs (``torchrun ...
    chip_smoke.py --tp-worker JOB``): ``init_mesh("1xN", "cuda")``, main's
    bf16 7B and the int8 7B, each whole from the seed and then split by
    ``shard_params``, main's session and the int8 pool through the decode
    graphs; rank 0 saves each decode's tokens to the job's ``out``."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from livecc_tpu_torch.core.mesh import close_mesh, init_mesh
    from livecc_tpu_torch.parallel.sharding import shard_params
    from livecc_tpu_torch.tools import session

    job = json.loads(spec)
    mesh = init_mesh(f"1x{os.environ['WORLD_SIZE']}", "cuda")
    out = {}
    try:
        for key, w8 in (("main", False), ("pool", True)):
            cfg, model = session.main_model(w8=w8)
            shard_params(model, cfg, mesh)
            record: list = []
            with decoding(False, record):
                if w8:
                    server = session.pool_server(cfg, model)
                    server.warmup([(session.HEIGHT, session.WIDTH)])
                    session.run_pool(server)
                    del server
                else:
                    session.run_session(session.new_engine(cfg, model), session.main_frames())
            out[key] = [(t.cpu(), g.cpu()) for t, g, _ in record]
            del model, record
            torch.cuda.empty_cache()
    finally:
        dist.barrier()
        close_mesh(mesh)
    if mesh.rank == 0:
        torch.save(out, job["out"])
    return 0


def smi_clocks() -> str:
    """The card's name, SM clock, power draw and power limit (nvidia-smi)."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def w8_parts(model) -> dict:
    """Bytes of an int8 model by kind: "codes" (int8), "scales" (the bf16
    per-output scales), "other" (every other tensor: norms, biases, the
    patch embedding, in bf16), and their sum "bytes"."""
    import torch

    parts = {"codes": 0, "scales": 0, "other": 0}
    for mod in model.modules():
        for name, t in [*mod._parameters.items(), *mod._buffers.items()]:
            if t is not None:
                kind = ("codes" if t.dtype == torch.int8 else "scales" if name == "scale"
                        else "other")
                parts[kind] += t.numel() * t.element_size()
    return dict(parts, bytes=sum(parts.values()))


def memory_bound_streams(plan) -> int:
    """The most streams ``plan``'s card holds beside its weights and its
    reserve: a memory bound, not a serving rate."""
    free = plan.hbm_bytes - plan.weights_bytes - plan.activation_reserve_bytes
    return free // plan.kv_bytes_per_stream


def zero2_partition(cfg4) -> None:
    """A one-process ``Zero2`` at ``Mesh(8, 1, 0, None, None, cuda)`` (no
    collective at n_model = 1) over a fresh ``layer_costs.new_model(cfg4)``,
    the ViT frozen: the bytes the card's allocator gives back when its fp32
    gradient buffers (this data rank's partition and the staging bucket)
    are dropped, requested and as allocated (512-byte blocks), against the
    training plan's ``grads_bytes`` at n_data = 8. Fails unless the
    requested bytes and the buffers' sizes equal the plan exactly."""
    import torch

    from livecc_tpu_torch.core.mesh import Mesh
    from livecc_tpu_torch.parallel import memory
    from livecc_tpu_torch.parallel.sharding import Zero2
    from livecc_tpu_torch.tools import layer_costs
    from livecc_tpu_torch.train.step import split_frozen

    model = layer_costs.new_model(cfg4)
    zero = Zero2(split_frozen(model, ("visual",))[0], Mesh(8, 1, 0, None, None,
                                                          torch.device("cuda")))
    plan = memory.training_plan(cfg4, n_data=8)
    buffers = {"partition": zero.grad.nbytes, "bucket": zero.bucket.nbytes}
    torch.cuda.synchronize()

    def held():
        stats = torch.cuda.memory_stats()
        return stats["requested_bytes.all.current"], stats["allocated_bytes.all.current"]

    before = held()
    zero.grad = zero.bucket = None
    after = held()
    requested, allocated = (a - b for a, b in zip(before, after))
    log(f"  Zero2 on one process at n_data = 8 over {cfg4.name} ({zero.part} of "
        f"{zero.flat.numel()} elements): fp32 gradient buffers {buffers}, the allocator gave "
        f"back {requested} B requested ({allocated} B allocated) on dropping them; the plan's "
        f"grads_bytes {plan.grads_bytes} (the parent held the whole {4 * zero.flat.numel()})")
    if requested != plan.grads_bytes or sum(buffers.values()) != plan.grads_bytes:
        raise AssertionError(f"memory_plan: Zero2 at n_data = 8 held {requested} B of fp32 "
                             f"gradient ({buffers}), {plan.grads_bytes} planned")
    del model, zero
    gc.collect()
    torch.cuda.empty_cache()


def phase_memory_plan(cfg, model, main: dict, pool: dict, w8: dict, rank_bytes: dict,
                      card: str) -> dict:
    """``parallel/memory.py``'s plans held to the bytes on the card, then
    ``tools/layer_costs.py``'s probes. Fails unless the plan's weight bytes
    equal main's bf16 7B (``session.model_bytes``) and ``tp_storage``'s
    rank at M = 2 and 4 exactly, and the int8 7B's (``w8_parts``) within
    1%, the gap being its scales plus one byte for each element kept in
    bf16; the KV plan equals main's bf16 cache exactly, and the pool's int8
    cache plus its bf16 scales (2 * L * Hk * Smax * 2 bytes a stream, which
    the plan does not count, as JAX's does not) exactly; and a ``Zero2`` on
    one process over ``layer_costs.width7b(4)`` with the ViT frozen, with
    its ``init_state``, holds the training plan's weights, grads, adam_m and
    adam_v exactly, and at n_data = 8 holds the plan's fp32 gradient bytes
    (``zero2_partition``). Logs the 7B's plans on this card with the most streams
    that fit (a memory bound), then runs the probes (``layer_costs.measure``,
    training also at depth 2), each a finding, never a gate: the 28-layer
    decode token at B = 1 projected from the (2, 4) difference beside
    main's replayed step, depth 2's step beside the (1, 3) line, and the
    depth-3 step's peak above its state beside the plan's activation
    reserve. The calibration runs at the start and the end, each beside
    the card's clocks and power. Fails unless the probes launched K1, K2
    and K4's forward and backward. Returns their launch counts."""
    import torch

    from livecc_tpu_torch.core.config import ModelConfig
    from livecc_tpu_torch.core.mesh import Mesh
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.parallel import memory
    from livecc_tpu_torch.parallel.sharding import Zero2
    from livecc_tpu_torch.tools import layer_costs, session
    from livecc_tpu_torch.train.step import split_frozen
    from livecc_tpu_torch.utils.calibrate import calibrate_matmul

    cal = calibrate_matmul()
    log(f"  calibration {cal} ({smi_clocks()})")
    gib = lambda n: f"{n / 2**30:.3f} GiB"
    # weights: bf16 at TP = 1, one rank at M = 2 and 4, int8
    for m, nbytes in {1: session.model_bytes(model), **rank_bytes}.items():
        want = memory.weights_bytes_per_chip(cfg, m)
        log(f"  bf16 weights at TP={m}: plan {want} B ({gib(want)}), on the card {nbytes} B")
        if nbytes != want:
            raise AssertionError(f"memory_plan: bf16 weights at TP={m}: {nbytes} on the card, "
                                 f"{want} planned")
    want = memory.weights_bytes_per_chip(cfg, 1, 1)
    gap = w8["bytes"] - want
    log(f"  int8 weights: plan {want} B ({gib(want)}), on the card {w8['bytes']} B "
        f"({gib(w8['bytes'])}), {gap / want:+.4%}: bf16 scales {w8['scales']} B and one more "
        f"byte for each of the {w8['other'] // 2} elements kept in bf16 (norms, biases, the "
        f"patch embedding)")
    if abs(gap) > 0.01 * want or gap != w8["scales"] + w8["other"] // 2:
        raise AssertionError(f"memory_plan: int8 weights {w8} against {want} planned")
    # KV: main's bf16 cache; the pool's int8 cache and its scales
    t = cfg.text
    kv = main["kv"]
    want = kv["rows"] * memory.kv_bytes_per_chip(cfg, 1, kv["len"])
    log(f"  bf16 KV of main ({kv['rows']} x {kv['len']}): plan {want} B, on the card "
        f"{kv['bytes']} B")
    if kv["bytes"] != want:
        raise AssertionError(f"memory_plan: main's KV {kv} against {want} planned")
    kv = pool["kv"]
    plan = memory.serving_plan(cfg, n_model=1, streams=kv["rows"], cache_len=kv["len"],
                               kv_dtype_bytes=1)
    want = plan.streams * plan.kv_bytes_per_stream
    scales = kv["rows"] * 2 * t.num_hidden_layers * t.num_key_value_heads * kv["len"] * 2
    log(f"  int8 KV of the pool ({kv['rows']} x {kv['len']}): plan {want} B + bf16 scales "
        f"{scales} B ({scales / kv['rows'] / 1e6:.2f} MB a stream, not in the plan), on the "
        f"card {kv['bytes']} + {kv['scales']} B")
    if kv["bytes"] != want or kv["scales"] != scales:
        raise AssertionError(f"memory_plan: the pool's KV {kv} against {want} + {scales}")
    # training state: one process's Zero2 over the 7B's width at depth 4
    cfg4 = layer_costs.width7b(4)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model4 = layer_costs.new_model(cfg4)
    trainable, frozen = split_frozen(model4, ("visual",))
    zero = Zero2(trainable, Mesh(1, 1, 0, None, None, torch.device("cuda")))
    state = zero.init_state(None)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    plan = memory.training_plan(cfg4, n_data=1)
    on_card = {"weights": sum(p.nbytes for p in frozen.values()) + zero.flat.nbytes,
               "grads": zero.grad.nbytes, "adam_m": state["mu"].nbytes,
               "adam_v": state["nu"].nbytes}
    planned = {"weights": plan.weights_bytes, "grads": plan.grads_bytes,
               "adam_m": plan.adam_m_bytes, "adam_v": plan.adam_v_bytes}
    log(f"  Zero2 on one process over {cfg4.name}, ViT frozen: on the card {on_card}, plan "
        f"{planned}; allocated {gib(held)} against the plan's {gib(sum(planned.values()))}")
    if on_card != planned:
        raise AssertionError(f"memory_plan: Zero2's state {on_card} against {planned}")
    del model4, trainable, frozen, zero, state
    gc.collect()
    torch.cuda.empty_cache()
    zero2_partition(cfg4)
    # the card's plans for the 7B at TP = 1
    for w_bytes, kv_bytes in ((2, 2), (2, 1), (1, 1)):
        for cache_len in (8192, 32768):
            plan = memory.serving_plan(cfg, n_model=1, streams=8, cache_len=cache_len,
                                       param_dtype_bytes=w_bytes, kv_dtype_bytes=kv_bytes)
            log(f"  plan: {plan.describe()}; {('int8', 'bf16')[w_bytes - 1]} weights, "
                f"{('int8', 'bf16')[kv_bytes - 1]} KV: at most {memory_bound_streams(plan)} "
                f"streams (a memory bound)")
    full = ModelConfig.qwen2_vl_7b()
    for n_data in (1, 8):
        log(f"  plan: {memory.training_plan(full, n_data=n_data).describe()}")
    # the probes
    build.reset_launch_counts()
    res = layer_costs.measure(f"chip_smoke memory_plan on {card}, {time.strftime('%Y-%m-%d')}",
                              emit=lambda line: log(f"  {line}"), train_depths=(1, 3, 2))
    counts = dict(build.launch_counts)
    proj = memory.serving_latency(cfg, res["costs"], n_model=1)
    off = proj.decode_ms_per_token / main["step_ms"] - 1
    log(f"  the 28-layer decode token at B=1 from the (2, 4) difference: "
        f"{proj.decode_ms_per_token:.3f} ms against main's replayed step {main['step_ms']:.3f} "
        f"ms, {off:+.2%} ({'hit' if abs(off) <= 0.10 else 'miss'} of the predicted +-10%)")
    tr = res["train"]
    line = (tr[1]["median_ms"] + tr[3]["median_ms"]) / 2
    off = tr[2]["median_ms"] / line - 1
    log(f"  training step at depth 2: {tr[2]['median_ms']:.2f} ms against the (1, 3) line's "
        f"{line:.2f} ms, {off:+.2%} ({'hit' if abs(off) <= 0.05 else 'miss'} of the predicted "
        f"+-5%)")
    act = tr[3]["peak_bytes"] - tr[3]["state_bytes"]
    log(f"  training at depth 3: peak {gib(tr[3]['peak_bytes'])} - state "
        f"{gib(tr[3]['state_bytes'])} = {gib(act)} against the plan's activation reserve "
        f"{gib(memory.training_plan(full, n_data=1).activation_reserve_bytes)}")
    log(f"  projection: {memory.serving_latency(full, res['costs'], n_model=1).describe()}")
    log(f"  projection: {memory.training_latency(full, res['train_costs']).describe()}")
    log(f"  calibration at the end {calibrate_matmul()} ({smi_clocks()})")
    missing = [k for k in ("flash_prefill", "flash_decode", "train_attention_fwd",
                           "train_attention_bwd") if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"memory_plan: the probes never launched {missing} ({counts})")
    log(f"  the probes' launches {counts}")
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


def phase_checkpoint_live(cfg, models: list, card: str) -> tuple[dict, dict, tuple]:
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
    ``session.new_engine`` on the source model. Then the web demo on the
    checkpoint (``phase_app``, the ``app`` phase). Returns the launch counts
    of the CLI's two runs and of the app's two runs."""
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
        app_counts = run_phase("app", lambda: phase_app(path, frames, tokenizer, work, card))
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
    return counts, counts_w8, app_counts



def preprocess_on_card(card: str) -> None:
    """``vision_io.device_preprocess`` on a 2-frame chunk of 720x1280 uint8
    frames resized to 308x560 (g = 880): the card's output within
    ``FP32_TOL`` of the same function on the CPU in fp32, two launches
    bit-equal, and its device time."""
    import torch

    from livecc_tpu_torch.tools import kernel_timing, session
    from livecc_tpu_torch.vision_io import device_preprocess

    frames = torch.from_numpy(session.synth_frames(2, *APP_SOURCE_HW, seed=session.SEED))
    kw = dict(out_h=session.HEIGHT, out_w=session.WIDTH)
    want = device_preprocess(frames, **kw)
    x = frames.cuda()
    got = device_preprocess(x, **kw)
    err = (got.cpu() - want).abs().max().item()
    if got.shape != want.shape or err > FP32_TOL:
        raise AssertionError(f"device_preprocess: {tuple(got.shape)} on the card, max abs diff "
                             f"{err:.3g} from the CPU (limit {FP32_TOL})")
    if not torch.equal(got, device_preprocess(x, **kw)):
        raise AssertionError("device_preprocess: two launches on the card differ")
    ms = kernel_timing.cuda_ms(lambda: device_preprocess(x, **kw))
    _, _, busy, groups = profiled(lambda: device_preprocess(x, **kw))
    log(f"  device_preprocess [2, {APP_SOURCE_HW[0]}, {APP_SOURCE_HW[1]}, 3] uint8 -> "
        f"{tuple(got.shape)} fp32 (values {want.min().item():.3f} .. {want.max().item():.3f}): "
        f"max abs diff {err:.3g} from the CPU in fp32, two launches bit-equal; {ms:.3f} ms "
        f"a call (median of single calls between CUDA events, host work included), device "
        f"busy {busy * 1e3:.3f} ms ({', '.join(f'{g} {t * 1e3:.3f}' for g, t in groups.items())}"
        f" ms) on {card}")


def http_get(url: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=600) as r:
        return r.read()


def http_post(url: str, body: str) -> str:
    import urllib.request

    req = urllib.request.Request(url, data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read().decode()


def phase_app(path: str, frames, tokenizer, work: str, card: str) -> tuple[dict, dict]:
    """The web demo on the checkpoint at ``path``: ``device_preprocess`` on
    the card (``preprocess_on_card``), then ``demo.app.DemoServer`` twice
    (bf16 weights; lookahead decoding with int8 weights), each played as
    the page plays it (``app_run``). Returns each run's launch counts."""
    import numpy as np

    from livecc_tpu_torch.vision_io import video_reader

    preprocess_on_card(card)
    if video_reader.has_ffmpeg():
        clip, loader = os.path.join(work, "app_clip.mp4"), None
        video_reader.encode_test_video(clip, frames, fps=CLIP_FPS)
    else:
        # the page's /video serves the file the loader reads
        clip = os.path.join(work, "app_clip.npy")
        np.save(clip, frames)
        loader = lambda p: FramesVideo(np.load(p), CLIP_FPS)   # noqa: E731
        log("  FFmpeg absent: the server reads the clip's frames from an .npy file through a "
            "video_loader (FramesVideo), and no commentary video is rendered")
    return tuple(app_run(label, clip, path, tokenizer, loader, kw, kernels, card, work)
                 for label, kw, kernels in (
                     ("bf16", {}, MAIN_KERNELS),
                     ("lookahead, int8 weights", dict(speculative=True, quantize_weights=True),
                      MAIN_W8_KERNELS)))


def app_run(label: str, clip: str, path: str, tokenizer, loader, kw: dict, kernels,
            card: str, work: str) -> dict:
    """One ``DemoServer`` (``kw``: its speculative and quantize_weights) on
    the checkpoint behind a threaded HTTP server on 127.0.0.1, played as
    the page plays it: ``GET /``, ``GET /video`` (the file's bytes), then
    every ``APP_POLL_S`` of wall a ``GET /tick?t=<elapsed>`` on a thread of
    its own (polls overlap and wait on the server's lock) until the clip's
    end plus 1 s, then one ``POST /qa``. The ``t`` the lock admitted, in
    its order (and, with lookahead, each dispatch's lookahead/plain choice),
    replayed through ``LiveCC.live_cc`` on a fresh session of the same
    engine must give the same bubbles, spans bit-equal, and its
    ``video_qa`` the same answer. ``kernels`` must have launched during the
    playback and QA (lookahead: verify windows too). Prints tick latency,
    span lag, lock waits, QA latency and tokens, load seconds; where FFmpeg
    is installed, renders the commentary video with the built-in TTS and
    reads it back. Returns the launch counts."""
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from livecc_tpu_torch.demo import app
    from livecc_tpu_torch.engine.graphs import graphs_for
    from livecc_tpu_torch.ops import build

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    server = app.DemoServer(clip, path, QUERY, tokenizer=tokenizer, video_loader=loader, **kw)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    engine = server.engine
    # the lock's order: server.tick notes when a request arrived, live_cc
    # (called under the lock) when it was admitted
    admitted, waits, arrived = [], [], threading.local()
    tick, live_cc = server.tick, server.live.live_cc

    def noted_tick(t):
        arrived.at = time.perf_counter()
        return tick(t)

    def admitted_live_cc(session, t, **kw2):
        waits.append(time.perf_counter() - arrived.at)
        admitted.append(t)
        return live_cc(session, t, **kw2)

    server.tick, server.live.live_cc = noted_tick, admitted_live_cc
    choices = []
    if engine.spec is not None:
        spec_on = engine._spec_on
        engine._spec_on = lambda: choices.append(spec_on()) or choices[-1]

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), app.make_handler(server))
    serve = threading.Thread(target=httpd.serve_forever, daemon=True)
    serve.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    polls, polls_lock = [], threading.Lock()
    try:
        if http_get(url + "/") != app.PAGE.encode():
            raise AssertionError(f"app {label}: GET / is not the page")
        with open(clip, "rb") as f:
            if http_get(url + "/video") != f.read():
                raise AssertionError(f"app {label}: GET /video is not the clip's bytes")
        graphs_for(engine.model, engine.cfg).reset_stats()
        build.reset_launch_counts()
        start = time.perf_counter()

        def poll(t):
            sent = time.perf_counter()
            body = json.loads(http_get(f"{url}/tick?t={t!r}"))
            done = time.perf_counter()
            with polls_lock:
                polls.append((t, done - sent, body, done - start))

        threads = []
        while True:
            time.sleep(max(0.0, start + len(threads) * APP_POLL_S - time.perf_counter()))
            elapsed = time.perf_counter() - start
            if elapsed > CLIP_SECONDS + 1:
                break
            threads.append(threading.Thread(target=poll, args=(elapsed,)))
            threads[-1].start()
        for thread in threads:
            thread.join(timeout=600)
        if any(thread.is_alive() for thread in threads) or len(polls) != len(threads):
            raise AssertionError(f"app {label}: {len(threads)} ticks sent, {len(polls)} answered")
        t0 = time.perf_counter()
        answer = http_post(url + "/qa", APP_QUESTION)
        qa_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = dict(build.launch_counts)
        qa_tokens = engine.chunk_log[-1].generated_tokens
        windows = sum(r.windows for r in engine.chunk_log)
        graph_stats = graphs_for(engine.model, engine.cfg).stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        serve.join(timeout=60)
    if serve.is_alive():
        raise AssertionError(f"app {label}: the HTTP server did not stop")

    # the replay: the admitted t, in order, on a fresh session of the engine
    if engine.spec is not None:
        engine._spec_on = iter(list(choices)).__next__
    session = server.live.open(clip)
    t0 = time.perf_counter()
    want = [[[t_a, t_b], text] for t in admitted
            for (t_a, t_b), text in live_cc(session, t, query=QUERY)]
    want_answer = server.live.video_qa(session, APP_QUESTION)
    replay_s = time.perf_counter() - t0
    body_of = {t: body for t, _, body, _ in polls}
    got = [bubble for t in admitted for bubble in body_of[t]]
    if sorted(admitted) != sorted(body_of) or got != want:
        raise AssertionError(f"app {label}: the served bubbles differ from LiveCC.live_cc "
                             f"replayed over the admitted t: {got} != {want}")
    if answer != want_answer:
        raise AssertionError(f"app {label}: the QA answer differs from the replay's video_qa")
    spans = [tuple(span) for span, _ in got]
    if spans[0] != (0.0, 3.0) or any(b0 != a1 for (_, a1), (b0, _) in zip(spans, spans[1:])) \
            or spans[-1][1] != CLIP_SECONDS or not all(text for _, text in got) or not answer:
        raise AssertionError(f"app {label}: spans {spans} not contiguous from the 3 s init "
                             f"window to {CLIP_SECONDS} s, or a bubble or the answer empty")
    missing = [name for name in kernels if counts.get(name, 0) <= 0]
    if missing or (engine.spec is not None and windows <= 0):
        raise AssertionError(f"app {label}: never launched {missing} (verify windows: {windows})")

    lat = np.array([latency for _, latency, _, _ in polls]) * 1e3
    carried = np.array([latency for _, latency, body, _ in polls if body]) * 1e3
    lag = np.array([done - span[1] for _, _, body, done in polls for span, _ in body])
    log(f"  app {label}: load (DemoServer: build_engine, load_checkpoint"
        f"{', quantize' if kw.get('quantize_weights') else ''}, LiveCC.open) {load_s:.2f} s; "
        f"{len(polls)} ticks every {APP_POLL_S} s of wall over {CLIP_SECONDS} s + 1 s; "
        f"tick latency (send to parsed JSON) p50 {np.percentile(lat, 50):.1f} ms, "
        f"p99 {np.percentile(lat, 99):.1f} ms, max {lat.max():.1f} ms (the {len(carried)} "
        f"that carried a chunk: p50 {np.percentile(carried, 50):.1f} ms, max "
        f"{carried.max():.1f} ms); "
        f"{sum(w > APP_WAITED_S for w in waits)} ticks waited on the lock (over "
        f"{APP_WAITED_S * 1e3:.0f} ms; longest {max(waits) * 1e3:.1f} ms); "
        f"span lag (arrival minus t1 on the playback clock) p50 {np.percentile(lag, 50):.3f} "
        f"s, max {lag.max():.3f} s over {len(lag)} spans; QA {qa_s:.2f} s for {qa_tokens} tokens "
        f"({qa_s / max(qa_tokens, 1) * 1e3:.2f} ms a token); on {card}")
    chosen = f"; lookahead chosen in {sum(choices)} of {len(choices)} dispatches" if choices else ""
    log(f"  app {label}: first tick (init chunk, graph captures) {min(polls)[1]:.3f} s; "
        f"decode graphs {graph_stats}; verify windows {windows}{chosen}; launches {counts}")
    log(f"  app {label}: {len(got)} bubbles and the answer equal LiveCC.live_cc replayed over the "
        f"{len(admitted)} admitted t and video_qa on a fresh session ({replay_s:.2f} s)")
    for (t_a, t_b), text in got:
        log(f"  app [{t_a:4.1f}-{t_b:4.1f}s] {text!r}"[:160])
    log(f"  app QA: {answer!r}"[:160])
    if loader is None:
        render_check(label, clip, got, work)
    del server, engine, session
    return counts


def render_check(label: str, clip: str, bubbles: list, work: str) -> None:
    """The run's result JSON through ``demo.render.render_commentary_video``
    with the built-in TTS: 1 + fps * seconds frames and an audio track."""
    from livecc_tpu_torch.demo.render import render_commentary_video
    from livecc_tpu_torch.vision_io import video_reader

    result = os.path.join(work, "app_result.json")
    with open(result, "w") as f:
        json.dump({"video_path": clip, "query": QUERY,
                   "commentaries": [[t_a, t_b, text] for (t_a, t_b), text in bubbles]}, f)
    out = os.path.join(work, "app_render.mp4")
    t0 = time.perf_counter()
    render_commentary_video(result, out, fps=CLIP_FPS)
    seconds = time.perf_counter() - t0
    end = float(video_reader.VideoReader(clip).pts_seconds[-1])
    n, audio = len(video_reader.VideoReader(out)), video_reader.load_audio(out, 16000)
    if n != 1 + round(end * CLIP_FPS) or len(audio) == 0:
        raise AssertionError(f"app {label}: the render has {n} frames (want "
                             f"{1 + round(end * CLIP_FPS)}) and {len(audio)} audio samples")
    log(f"  app {label}: rendered {n} frames with the built-in TTS's track ({len(audio)} "
        f"samples at 16 kHz) in {seconds:.2f} s")

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


def vit_held(q, k, v, label: str, required: bool) -> float:
    """K3 on bf16 q, k, v [NG, g, H, D] against ``kernel_check``'s blocked
    plain version by ``held``, with the heaviest key tile of the last
    group's last query tile (head 3) dropped as the planted fault."""
    import torch

    from livecc_tpu_torch.ops.vit_attention import vit_group_attention
    from livecc_tpu_torch.tools import kernel_check

    ng, g, h, d = q.shape
    tile = kernel_check.TILE
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


def k4_fwd_held(qs, k, v, seg, n_real: int, label: str, required: bool) -> float:
    """K4's forward on pre-scaled qs [B, S, Hq, D], k, v and segment ids
    against ``kernel_check``'s blocked plain version by ``held`` (lse by
    ``close`` in fp32), with the heaviest key tile of batch row 0's last
    full query tile of its first ``n_real`` tokens (head 3) dropped as the
    planted fault."""
    import torch

    from livecc_tpu_torch.ops.train_attention import train_attention_fwd
    from livecc_tpu_torch.tools import kernel_check

    s, hq, hk = qs.shape[1], qs.shape[2], k.shape[2]
    tile = kernel_check.TILE
    o, lse = train_attention_fwd(qs, k, v, seg)
    ro, rlse = kernel_check.train_attention_fwd_blocked(qs, k, v, seg)
    qt = n_real // tile - 1
    rows = slice(qt * tile, (qt + 1) * tile)
    pos = torch.arange(s, device=qs.device)
    kt = heaviest_key_tile(qs[0, rows, 3].float(), k[0, :, 3 // (hq // hk)].float(),
                           (pos[None, :] <= pos[rows, None]) & (seg[0, None, :] == 1))
    bad_o, _ = kernel_check.dropped_fwd_tile(qs, k, v, seg, ro, rlse, qt, kt, 3)
    lse_share = kernel_check.close(lse, rlse, torch.float32)
    log(f"  {'train_attention_fwd':20s} {label} lse: worst {lse_share:.3f} of the fp32 limit")
    if not lse_share <= 1.0:
        raise AssertionError(f"train_attention_fwd {label}: lse {lse_share:.3f}x the limit")
    return held("train_attention_fwd", label, o, ro, bad_o, required,
                f"dropped key tile {kt} of query tile {qt}")


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

    gen = torch.Generator(device=store["vit"][0].device).manual_seed(14)
    results = {}

    def randn_like(x):
        return torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)

    with torch.inference_mode():
        q, k, v = store["vit"]
        ng, g, h, d = q.shape
        shape = f"NG={ng} g={g} H={h} D={d} bf16"
        err = vit_held(q, k, v, f"{shape} (the item's last ViT block)", False)
        err = max(err, vit_held(*(randn_like(x) for x in (q, k, v)), f"{shape} (random)", True))
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
        err = k4_fwd_held(qs, k, v, seg, n_real, f"{shape} (the item's last LLM layer)", False)
        err = max(err, k4_fwd_held(prescaled(randn_like(q)), randn_like(k), randn_like(v), seg,
                                   n_real, f"{shape} (random)", True))
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


def sdpa_eval(q, k, v, causal, do=None):
    """The one PyTorch call beside an eval kernel: SDPA on K3's groups
    (``causal`` None: [NG, g, H, D], bidirectional), or on K4's real tokens
    (pre-scaled q [1, n, Hq, D], GQA, ``is_causal``); with ``do``, K4's
    backward: the gradients of a forward made outside the timing."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if causal is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt)
    if do is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=1.0,
                                                      enable_gqa=True)
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=1.0, enable_gqa=True)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True)


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
            f"{rec['tokens_per_s']:.0f} tokens/s  model {rec['model_tflops']:.1f} TFLOP/s  "
            f"step peak {rec['peak_gib']:.2f} GiB")
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


class SeededSource:
    """``VideoReader``'s API over a source of ``n`` frames at ``fps`` frames
    a second that reports ``source_hw`` as its frame size and holds no
    frame: frame i, at whatever size the reader asks for, is drawn from
    numpy seed ``seed * 1_000_003 + i``. The train_cli phase's
    ``video_loader`` where no FFmpeg is installed (``FramesVideo`` serves
    one size, and the dataset reads a clip at one size for a streaming row
    and another for a plain row)."""

    def __init__(self, n: int, fps: float, source_hw, seed: int):
        import numpy as np

        self.n, self.avg_fps, self.frame_size, self.seed = n, float(fps), tuple(source_hw), seed
        self.pts_seconds = np.arange(n) / self.avg_fps

    def __len__(self) -> int:
        return self.n

    def get_batch(self, indices, out_hw=None):
        import numpy as np

        h, w = out_hw or self.frame_size
        return np.stack([np.random.RandomState(self.seed * 1_000_003 + int(i)).randint(
            0, 256, (h, w, 3), dtype=np.uint8) for i in indices])


def cli_sources(root: str) -> dict:
    """The train_cli clips under ``root``: path -> ``SeededSource``."""
    return {os.path.join(root, f"clip_{seconds}s.mp4"): SeededSource(
                int(seconds * CLI_SOURCE_FPS), CLI_SOURCE_FPS, CLI_SOURCE_HW, CLI_SEED + i)
            for i, seconds in enumerate(CLI_CLIPS)}


def train_cli_corpus(root: str, ffmpeg: bool):
    """The train_cli corpus under ``root``: a JSONL file in the Live-CC-5M
    schema with the port's seek index (``write_seek_index``), one streaming
    row per clip of ``CLI_CLIPS`` seconds (a query and an ASR
    ``text_stream`` of [start, end, word] at ``CLI_WORDS_PER_S`` words a
    second) and a plain video-QA row over the first clip. The clips are
    ``SeededSource``s of ``CLI_SOURCE_HW`` at ``CLI_SOURCE_FPS``: encoded by
    the port's ``encode_test_video`` where ``ffmpeg``, else served by the
    returned ``video_loader``. Returns (corpus path, video_loader or None)."""
    import numpy as np

    from livecc_tpu_torch.data.lmm_dataset import write_seek_index
    from livecc_tpu_torch.vision_io.video_reader import encode_test_video

    rng = np.random.RandomState(CLI_SEED)
    sources, rows = cli_sources(root), []
    for path, seconds in zip(sources, CLI_CLIPS):
        n_words = int(seconds * CLI_WORDS_PER_S)
        stream = [[round(j / CLI_WORDS_PER_S, 2), round(j / CLI_WORDS_PER_S + 0.32, 2),
                   str(rng.choice(CLI_VOCAB))] for j in range(n_words)]
        rows.append([{"role": "user", "content": [{"type": "video", "video": path},
                                                  {"type": "text", "text": CLI_QUERY}]},
                     {"role": "assistant", "content": [{"type": "text", "text_stream": stream}]}])
    first = os.path.join(root, f"clip_{CLI_CLIPS[0]}s.mp4")
    rows.append([{"role": "user", "content": [{"type": "video", "video": first},
                                              {"type": "text", "text": CLI_QUESTION}]},
                 {"role": "assistant", "content": [{"type": "text", "text": CLI_ANSWER}]}])
    path = os.path.join(root, "live_cc.jsonl")
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    write_seek_index(path)
    if not ffmpeg:
        return path, sources.__getitem__
    for clip, src in sources.items():
        encode_test_video(clip, src.get_batch(range(len(src))), fps=int(CLI_SOURCE_FPS))
    return path, None


def phase_train_cli() -> dict:
    """The training front door (``python -m livecc_tpu_torch.train.cli``)
    on the 7B's width at LiveCC's sample length. The checkpoint:
    Qwen2-VL-7B at full width with the LLM cut to 4 layers
    (``train_session.train_model_config``), bf16 weights drawn on the card
    from a seed and written by ``tools/checkpoint.py:save_checkpoint`` under
    ``build/`` (config.json: ``tests/fixtures/qwen2_vl_7b_config.json`` with
    ``num_hidden_layers`` 4); ``ByteTokenizer.for_config``. The corpus
    (``train_cli_corpus``): streaming rows of 30, 60 and 120 s of a
    360x640 source and a plain QA row, read through ``LMMDataset`` (frames
    from ``SeededSource`` where FFmpeg is absent). First every sample once,
    printed (row length, bucket, K3's (NG, g)); one must land in the 32768
    bucket. Then ``cli.main`` with ``--total_steps 3 --accum_steps 2
    --save_steps 3 --freeze_modules visual`` (defaults otherwise: no
    packing, remat=True, lr 2e-5), and again with ``--total_steps 4``,
    which resumes from step 3 (its restored parameters must equal those
    saved) and takes step 4. Checks: steps 1-3 and 4, finite losses, no
    retries, the text parameters train's phase checks moved (all but the
    bf16 norm scales), the frozen ViT bit-unchanged, K3 and K4's forward
    and backward launched in each run. Prints each step's wall, tokens,
    rates and peak memory, the seconds to save and restore ``state.pt``
    and its size. Then on the longest sample (one 32768-bucket
    micro-batch): forward and backward under each of ``CLI_REMATS``
    (losses bit-equal to remat=True's; the checked gradients bit-equal or
    within ``kernel_check.grad_close`` of remat=True's; wall and peak
    memory each), and one profiled micro-step under remat=True (device time
    by group, idle share, K4's share). Last, ``train_cli_kernels`` at the
    samples' shapes. The step records are the trainer's own (``log.jsonl``:
    wall, peak memory, load, save and restore seconds), the window's work
    comes through ``cli.main``'s ``on_step``; only ``Trainer.try_restore``,
    a public method, is wrapped, in the resumed run, to hold what it
    restored. Returns the launch counts of the two CLI runs and what the
    ``mesh`` phase reuses (the work directory under ``build/``, which the
    caller removes after that phase; the checkpoint, the corpus, the flags,
    steps 1-3's records)."""
    import shutil

    import numpy as np
    import torch

    from livecc_tpu_torch.data.lmm_dataset import LMMDataset
    from livecc_tpu_torch.data.tokenizer import ByteTokenizer
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import train_session as ts
    from livecc_tpu_torch.tools.checkpoint import save_checkpoint
    from livecc_tpu_torch.train import cli
    from livecc_tpu_torch.train import trainer as tr
    from livecc_tpu_torch.train.data import SEQ_BUCKETS
    from livecc_tpu_torch.vision_io import video_reader

    cfg = ts.train_model_config()
    tokenizer = ByteTokenizer.for_config(cfg)
    work = os.path.join(ROOT, "build", "train_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        ffmpeg = video_reader.has_ffmpeg()
        corpus, loader = train_cli_corpus(work, ffmpeg)
        log(f"  corpus {corpus}: clips of {list(CLI_CLIPS)} s of a {CLI_SOURCE_HW[0]}x"
            f"{CLI_SOURCE_HW[1]} source at {CLI_SOURCE_FPS:g} fps, "
            + ("encoded and decoded by the port's reader (FFmpeg found)" if ffmpeg else
               "frames from SeededSource through a video_loader (no FFmpeg here)"))

        # every sample once, through the dataset the CLI builds
        ds = LMMDataset(annotation_paths=[corpus], tokenizer=tokenizer, cfg=cfg,
                        video_loader=loader)
        longest, buckets, vit_shapes, k4_rows = None, [], set(), {}
        for i in range(len(ds)):
            x = ds[i]
            n = x["input_ids"].shape[1]
            bucket = next(b for b in SEQ_BUCKETS if n <= b)
            grids = x["video_grid_thw"]
            k3 = sorted({(int(g[1] * g[2])) for g in grids})
            if len(k3) == 1:
                vit_shapes.add((int(grids[:, 0].sum()), k3[0]))
            log(f"  sample {i}: {n} tokens ({int((x['labels'] != -100).sum())} supervised, "
                f"{int((x['input_ids'] == cfg.video_token_id).sum())} video) in the {bucket} "
                f"bucket; K3 (NG, g) = ({int(grids[:, 0].sum())}, {k3[0] if len(k3) == 1 else k3})"
                f"; {x['pixel_patches'].shape[0]} patches")
            buckets.append(bucket)
            k4_rows[bucket] = max(k4_rows.get(bucket, 0), n)
            if longest is None or n > longest["input_ids"].shape[1]:
                longest = x
        if ds.retries:
            raise AssertionError(f"train_cli: the dataset retried {ds.retries} samples")
        if max(buckets) != SEQ_BUCKETS[-1]:
            raise AssertionError(f"train_cli: no sample in the {SEQ_BUCKETS[-1]} bucket: {buckets}")
        del ds

        # the checkpoint
        model = ts.train_model(cfg)
        config_json = os.path.join(work, "config.json")
        with open(os.path.join(ROOT, "tests", "fixtures", "qwen2_vl_7b_config.json")) as f:
            config = json.load(f)
        config["num_hidden_layers"] = cfg.text.num_hidden_layers
        with open(config_json, "w") as f:
            json.dump(config, f)
        ckpt = os.path.join(work, "ckpt_7b_d4")
        t0 = time.perf_counter()
        save_checkpoint(model, cfg, ckpt, config_json)
        log(f"  checkpoint {ckpt}: {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
            f"params bf16 written in {time.perf_counter() - t0:.1f} s; disk free "
            f"{shutil.disk_usage(work).free / 1e9:.1f} GB")
        checked = {n: p.detach().cpu() for n, p in model.text.named_parameters()
                   if n.startswith("layers.0.") or n in ("final_ln.weight", "lm_head.weight")}
        visual = {n: p.detach().cpu() for n, p in model.visual.named_parameters()}
        del model
        gc.collect()
        torch.cuda.empty_cache()

        out = os.path.join(work, "out")
        flags = ["--annotation_paths", corpus, "--pretrained", ckpt, "--output_dir", out,
                 "--accum_steps", "2", "--save_steps", "3", "--freeze_modules", "visual",
                 "--log_steps", "1"]
        windows, counts, lasts, state_gb = {}, [], [], []

        def on_step(step, batch, metrics):
            """The window's work, for the rates beside the trainer's record."""
            flops, tokens = ts.window_flops(cfg, batch)
            windows[step] = {
                "flops": flops, "tokens": tokens, "padded": batch.input_ids.numel(),
                "bucket": batch.input_ids.shape[-1], "supervised": int(metrics["tokens"]),
                "k3": "none" if batch.vision_patches is None else (
                    f"groups (NG, g) = ({batch.vision_patches.shape[-2] // batch.vision_group}, "
                    f"{batch.vision_group})" if batch.vision_group else "bounds form (mixed grids)")}

        def restore(real):
            """Trainer.try_restore, then its parameters held to step 3's
            state.pt, which is then dropped (disk)."""
            def run(self):
                ok = real(self)
                same = ok and self.step == 3 and all(
                    torch.equal(p.detach().cpu(), step3[n])
                    for n, p in self.model.named_parameters())
                if not same:
                    raise AssertionError("train_cli: the resume did not restore the parameters "
                                         "saved at step 3")
                shutil.rmtree(os.path.join(out, "ckpt", "3"))
                return ok
            return run

        for steps in (3, 4):
            build.reset_launch_counts()
            argv = flags + ["--total_steps", str(steps)]
            if steps == 3:
                lasts.append(cli.main(argv, tokenizer=tokenizer, video_loader=loader,
                                      on_step=on_step))
                saved = os.path.join(out, "ckpt", "3", "state.pt")
                state_gb.append(os.path.getsize(saved) / 1e9)
                # host copies: a mapping of the file would keep its 21.6 GB on
                # the card machine's disk through step 4's save
                step3 = {n: t.clone() for n, t in torch.load(
                    saved, map_location="cpu", mmap=True)["params"].items()}
            else:                   # the resumed run: the step-3 state, checked and dropped
                real = tr.Trainer.try_restore
                tr.Trainer.try_restore = restore(real)
                try:
                    lasts.append(cli.main(argv, tokenizer=tokenizer, video_loader=loader,
                                          on_step=on_step))
                finally:
                    tr.Trainer.try_restore = real
                state_gb.append(os.path.getsize(os.path.join(out, "ckpt", "4", "state.pt")) / 1e9)
            counts.append(dict(build.launch_counts))
            gc.collect()
            torch.cuda.empty_cache()
        with open(os.path.join(out, "log.jsonl")) as f:
            records = [json.loads(line) for line in f]
        for rec in records:
            w = windows[rec["step"]]
            log(f"  step {rec['step']}: wall {rec['wall_s']:.3f} s  loss {rec['loss']:.4f}  "
                f"tokens {w['tokens']} real / {w['padded']} padded (bucket {w['bucket']}), "
                f"{w['supervised']} supervised  {w['tokens'] / rec['wall_s']:.0f} tokens/s  model "
                f"{w['flops'] / rec['wall_s'] / 1e12:.1f} TFLOP/s  peak {rec['peak_gib']:.2f} GiB  "
                f"window loaded in {rec['load_s']:.2f} s  K3 {w['k3']}")
        log(f"  state.pt: {state_gb} GB, saved in "
            f"{[round(r['save_s'], 2) for r in records if 'save_s' in r]} s (steps 3, 4), "
            f"restored in {[round(r['restore_s'], 2) for r in records if 'restore_s' in r]} s "
            f"(step {[r['restored_step'] for r in records if 'restored_step' in r]}; the first "
            f"run found none)")
        log(f"  last records: {lasts}; launches {counts}")
        if [r["step"] for r in records] != [1, 2, 3, 4]:
            raise AssertionError(f"train_cli: steps {[r['step'] for r in records]}, not 1-4")
        if not all(np.isfinite(r["loss"]) for r in records):
            raise AssertionError(f"train_cli: non-finite losses {[r['loss'] for r in records]}")
        if any(last.get("retries") != 0 for last in lasts):
            raise AssertionError(f"train_cli: the dataset retried: {lasts}")
        for c in counts:
            missing = [name for name in TRAIN_KERNELS if c.get(name, 0) <= 0]
            if missing:
                raise AssertionError(f"train_cli: a run never launched {missing}")
        # the first update has learning rate 0; steps 2-3 move what trains,
        # but bf16 norm scales at 1.0 (an update below half a bf16 step)
        stay = [n for n in checked if n.endswith("ln.weight")]
        moved = [n for n in checked if not torch.equal(step3["text." + n], checked[n])]
        if set(moved) != set(checked) - set(stay):
            raise AssertionError(f"train_cli: params that did not move: "
                                 f"{sorted(set(checked) - set(stay) - set(moved))}")
        if not all(torch.equal(step3["visual." + n], p) for n, p in visual.items()):
            raise AssertionError("train_cli: the frozen ViT changed")
        log(f"  moved by step 3: {len(moved)} of the {len(checked)} checked tensors; the ViT "
            f"bit-unchanged; the resume restored step 3's parameters bit for bit")
        del step3, visual
        gc.collect()

        remat_ab(cfg, ckpt, longest, checked)
        train_cli_kernels(k4_rows, sorted(vit_shapes))
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    total = {}
    for c in counts:
        for name, n in c.items():
            total[name] = total.get(name, 0) + n
    at = flags.index("--output_dir")
    return total, {"work": work, "out": out, "ckpt": ckpt, "flags": flags[:at] + flags[at + 2:],
                   "tokenizer": tokenizer, "loader": loader, "records": records[:3],
                   "ffmpeg": ffmpeg}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_mesh(run: dict) -> dict:
    """Multi-device training (``train.cli --mesh``) on train_cli's
    checkpoint (the 7B's width, the LLM at 4 layers) and corpus, with
    train_cli's first run's flags (3 steps, accum 2, the ViT frozen) plus
    ``--mesh 1x1``: the default process group over NCCL at world size 1
    from torchrun's variables set in this process (the CLI destroys the
    group at its end), the TP layers and ``vocab_parallel_ce`` at M = 1 and
    the flat ZeRO-2 update at D = 1, every collective issued. Checks: steps
    1 and 2's losses those of train_cli's no-mesh run within 1e-6 relative
    (the same arithmetic; the first update has learning rate 0), step 3's
    within ``kernel_check.close``'s bf16 limit (the global norm sums the
    flat partition in another order); NCCL collectives in the profile; K3 and
    K4's forward and backward launched; the step-3 ``state.pt`` loads in
    the no-mesh ``Trainer`` (step, count and tensors equal to the file's).
    Prints each step's wall and peak memory beside train_cli's, and step 3
    under the profiler (host and device activity, started after step 2's
    work): the idle share, the collectives' count (the dispatcher's
    ``c10d::<op>`` ranges; at least one, the backend NCCL) and the device
    time under them, device time by group. After each backward (at each
    ``Zero2.accumulate``) it reads the bf16 ``.grad`` bytes still alive,
    the allocation and the step's peak so far: ZeRO-2's hooks take every
    ``.grad`` during the backward, so it fails unless they are 0 (the
    parent held every trainable parameter's), and it prints each step's
    peak and where it lies (PERF.md compares them with the parent's). Where
    the machine has 2 cards, ``--mesh 2x1`` through torchrun over NCCL (4
    cards: ``2x2`` too), held to the 1x1 run's losses by the bf16 limit,
    each rank printing its ZeRO-2 partition's bytes; it prints the world
    sizes it ran. Returns the 1x1 run's launch counts and its log records
    (``sp_pp`` holds SP to them)."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from livecc_tpu_torch.models.qwen2_vl.convert import load_checkpoint
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.parallel.sharding import Zero2
    from livecc_tpu_torch.tools import kernel_check
    from livecc_tpu_torch.tools.profile_stream import busy_seconds, device_groups
    from livecc_tpu_torch.train import cli
    from livecc_tpu_torch.train.step import TrainConfig
    from livecc_tpu_torch.train.trainer import Trainer, TrainerConfig

    shutil.rmtree(os.path.join(run["out"], "ckpt"), ignore_errors=True)   # train_cli's 21.6 GB
    out = os.path.join(run["work"], "mesh_1x1")
    window = {}
    probes = []                                 # one a backward
    real_accumulate = Zero2.accumulate

    def accumulate(zero):
        """Right after a backward: the bf16 gradient bytes alive (``.grad``s
        and any ``Zero2`` holds for its buckets), the trainable bytes (what
        the parent held there), the allocation and
        the step's peak so far (the Trainer resets it after each step)."""
        probes.append({
            "grad_bytes": sum(p.grad.nbytes for p in zero.params.values() if p.grad is not None)
            + sum(g.nbytes for g in zero._held.values()),
            "trainable_bytes": sum(p.nbytes for p in zero.params.values()),
            "allocated": torch.cuda.memory_allocated(),
            "peak": torch.cuda.max_memory_allocated()})
        real_accumulate(zero)

    def on_step(step, batch, metrics):
        """Step 3 under the profiler, from the end of step 2's work."""
        if step in (2, 3):
            torch.cuda.synchronize()
        if step == 2:
            window["backend"] = dist.get_backend()
            window["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            window["prof"].start()
            window["t0"] = time.perf_counter()
        elif step == 3:
            window["wall"] = time.perf_counter() - window["t0"]
            window["prof"].stop()

    build.reset_launch_counts()
    Zero2.accumulate = accumulate
    try:
        with torchrun_vars():
            last = cli.main(run["flags"] + ["--output_dir", out, "--total_steps", "3", "--mesh",
                                            "1x1"],
                            tokenizer=run["tokenizer"], video_loader=run["loader"],
                            on_step=on_step)
    finally:
        Zero2.accumulate = real_accumulate
    counts = dict(build.launch_counts)
    if dist.is_initialized():
        raise AssertionError("mesh: the CLI left its process group")
    with open(os.path.join(out, "log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    log(f"  --mesh 1x1 over NCCL at world size 1: last record {last}; launches {counts}")
    if [r["step"] for r in records] != [1, 2, 3] or last.get("retries") != 0:
        raise AssertionError(f"mesh: steps {[r['step'] for r in records]}, {last}")
    for rec, r in zip(records, run["records"]):
        a, b = rec["loss"], r["loss"]
        share = kernel_check.close(torch.tensor([a]), torch.tensor([b]), torch.bfloat16)
        same = "bit-equal" if a == b else f"rel {abs(a - b) / abs(b):.2e}"
        log(f"  step {rec['step']}: loss {a:.6f} vs no-mesh {b:.6f} ({same}; {share:.4f} of "
            f"close's bf16 limit); tokens {rec['tokens']} vs {r['tokens']}; wall "
            f"{rec['wall_s']:.3f} s vs {r['wall_s']:.3f} s; peak {rec['peak_gib']:.2f} GiB vs "
            f"{r['peak_gib']:.2f} GiB; window loaded in {rec['load_s']:.2f} s"
            + (" (under the profiler)" if rec["step"] == 3 else ""))
        if rec["tokens"] != r["tokens"]:
            raise AssertionError(f"mesh step {rec['step']}: tokens {rec['tokens']} vs {r['tokens']}")
        if rec["step"] <= 2 and not abs(a - b) <= 1e-6 * abs(b):
            raise AssertionError(f"mesh step {rec['step']}: loss {a} is not the no-mesh {b}")
        if not share <= 1.0:
            raise AssertionError(f"mesh step {rec['step']}: loss {a} vs {b}: {share:.3f}x the limit")
    # the gradients: no bf16 .grad alive after any backward, and where each
    # step's peak lies (by the end of its backwards, or after: the update)
    per = len(probes) // len(records)
    gib = lambda n: f"{n / 2**30:.2f}"
    for i, rec in enumerate(records):
        step = probes[i * per:(i + 1) * per]
        by_backward = max(p["peak"] for p in step)
        where = ("in the forward / backward" if by_backward >= rec["peak_gib"] * 2**30
                 else "after the backwards (the update)")
        log(f"  step {rec['step']}: bf16 .grad bytes alive after each backward "
            f"{[p['grad_bytes'] for p in step]} (every trainable parameter's: "
            f"{step[0]['trainable_bytes']}); allocated {[gib(p['allocated']) for p in step]} GiB, "
            f"peak so far {[gib(p['peak']) for p in step]} GiB; the step's peak "
            f"{rec['peak_gib']:.2f} GiB, {where}")
    left = [p["grad_bytes"] for p in probes if p["grad_bytes"]]
    if len(probes) != per * len(records) or per < 1 or left:
        raise AssertionError(f"mesh: bf16 .grad bytes alive after the backwards: {probes}")
    missing = [name for name in TRAIN_KERNELS if counts.get(name, 0) <= 0]
    if missing:
        raise AssertionError(f"mesh: the run never launched {missing}")

    # the collectives: the dispatcher's "c10d::<op>" host ranges and the
    # device work launched inside them (at one rank NCCL launches no kernel:
    # an out-of-place collective is a device copy, an in-place one nothing)
    prof = window.pop("prof")
    events = prof.events()
    colls = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
             and e.name.startswith("c10d::")]
    coll_s = sum(getattr(e, "device_time_total", 0.0) for e in colls) / 1e6
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name.lower().startswith("nccl")]
    busy, groups = busy_seconds(prof), device_groups(prof)
    total = sum(groups.values())
    kinds = {}
    for e in colls:
        kinds[e.name] = kinds.get(e.name, 0) + 1
    log(f"  step 3 profiled (host and device activity): wall {window['wall']:.3f} s, device "
        f"busy {busy:.3f} s, idle share {1 - busy / window['wall']:.3f}; "
        f"{window['backend']} collectives "
        f"{len(colls)} {kinds}, device time under them {coll_s * 1e3:.3f} ms "
        f"({coll_s / total:.3%} of device time), NCCL kernels {len(kernels)}")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:28s} {t * 1e3:10.2f} ms  {t / total:6.1%}")
    if window["backend"] != "nccl" or not colls:
        raise AssertionError(f"mesh: backend {window['backend']}, {len(colls)} collectives "
                             f"in the profiled step")
    del prof, events

    # the mesh's state.pt in the no-mesh Trainer
    path = os.path.join(out, "ckpt", "3", "state.pt")
    t0 = time.perf_counter()
    cfg, model = load_checkpoint(run["ckpt"], "cuda", torch.bfloat16)
    trainer = Trainer(model, cfg, TrainConfig(total_steps=3, freeze_modules=("visual",)),
                      TrainerConfig(output_dir=out, total_steps=3, accum_steps=2, save_steps=None),
                      dataset=[])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    state = torch.load(path, map_location="cpu", mmap=True)
    names = ("text.layers.0.q_proj.weight", "text.layers.3.down_proj.weight",
             "text.lm_head.weight", "text.final_ln.weight")
    params = dict(model.named_parameters())
    same = trainer.step == 3 and trainer.opt_state["count"] == 3 and all(
        torch.equal(params[n].detach().cpu(), state["params"][n])
        and torch.equal(trainer.opt_state["nu"][n].cpu(), state["opt_state"]["nu"][n])
        for n in names)
    log(f"  the mesh's state.pt ({os.path.getsize(path) / 1e9:.1f} GB) in the no-mesh Trainer: "
        f"step {trainer.step}, count {trainer.opt_state['count']}, {len(names)} tensors and their "
        f"nu equal to the file's: {same} (model load + restore {load_s:.1f} s)")
    if not same:
        raise AssertionError("mesh: the no-mesh Trainer did not restore the mesh's state.pt")
    del trainer, model, params, state
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(out, "ckpt"), ignore_errors=True)

    worlds = [1]
    n_cards = torch.cuda.device_count()
    for n_data, n_model in ((2, 1), (2, 2)):
        if n_data * n_model > n_cards:
            continue
        spec = f"{n_data}x{n_model}"
        mout = os.path.join(run["work"], f"mesh_{spec}")
        job = {"work": run["work"], "ffmpeg": run["ffmpeg"],
               "argv": run["flags"] + ["--output_dir", mout, "--total_steps", "3",
                                       "--save_steps", "100", "--mesh", spec]}
        done = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc_per_node", str(n_data * n_model),
                               os.path.abspath(__file__), "--mesh-worker", json.dumps(job)],
                              capture_output=True, text=True, timeout=300)
        if done.returncode != 0:
            raise AssertionError(f"mesh {spec}: torchrun exited {done.returncode}: "
                                 f"{(done.stdout + done.stderr)[-3000:]}")
        for line in done.stdout.splitlines():
            if "ZeRO-2 partition" in line:
                log(f"  --mesh {spec} {line.strip()}")
        with open(os.path.join(mout, "log.jsonl")) as f:
            other = [json.loads(line) for line in f]
        if [r["step"] for r in other] != [1, 2, 3]:
            raise AssertionError(f"mesh {spec}: steps {[r['step'] for r in other]}")
        for rec, r in zip(other, records):
            share = kernel_check.close(torch.tensor([rec["loss"]]), torch.tensor([r["loss"]]),
                                       torch.bfloat16)
            log(f"  --mesh {spec} step {rec['step']}: loss {rec['loss']:.6f} vs 1x1 "
                f"{r['loss']:.6f} ({share:.4f} of close's bf16 limit); tokens {rec['tokens']}; "
                f"wall {rec['wall_s']:.3f} s; peak {rec['peak_gib']:.2f} GiB")
            if rec["tokens"] != r["tokens"] or not share <= 1.0:
                raise AssertionError(f"mesh {spec} step {rec['step']}: {rec} vs 1x1 {r}")
        worlds.append(n_data * n_model)
    log(f"  world sizes run: {worlds} ({n_cards} card(s) here; the multi-rank numbers come "
        f"from the CPU tests over gloo)")
    return counts, records


SP_PP_WINDOW = (4, 8192)        # PP's text window: A microbatches of S tokens


def seq_calls(issued):
    """Count the all-gathers and reduce-scatters the port issues (``parallel/
    tp.py``'s flat collectives look their torch function up at each call)."""
    import torch.distributed as dist

    names = {"all_gather": "all_gather_single" if hasattr(dist, "all_gather_single")
             else "all_gather_into_tensor",
             "reduce_scatter": "reduce_scatter_single" if hasattr(dist, "reduce_scatter_single")
             else "reduce_scatter_tensor", "send": "send", "recv": "recv"}
    saved = {name: getattr(dist, name) for name in names.values()}

    def counted(op, fn):
        def run(*args, **kw):
            issued[op] += 1
            return fn(*args, **kw)
        return run

    @contextlib.contextmanager
    def on():
        for op, name in names.items():
            setattr(dist, name, counted(op, saved[name]))
        try:
            yield
        finally:
            for name, fn in saved.items():
                setattr(dist, name, fn)
    return on()


def pp_window(cfg, dev):
    """PP's text window: ``SP_PP_WINDOW`` rows of seeded ids, the tail half
    supervised, positions 0..S-1, every key valid."""
    import torch

    from livecc_tpu_torch.train.step import Batch

    a, s = SP_PP_WINDOW
    gen = torch.Generator().manual_seed(CLI_SEED)
    ids = torch.randint(8, cfg.text.vocab_size, (a, 1, s), generator=gen)
    labels = ids.clone()
    labels[..., :s // 2] = -100
    pos = torch.arange(s).expand(a, 3, 1, s).contiguous()
    return Batch(input_ids=ids.to(dev), labels=labels.to(dev), position_ids=pos.to(dev),
                 attention_mask=torch.ones((a, 1, s), dtype=torch.bool, device=dev))


def profiled_steps(label, step, model, state, batch, n):
    """``n`` steps of ``step``, the last under the profiler: each step's
    loss, tokens, wall and peak memory, and the last one's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from livecc_tpu_torch.tools.profile_stream import busy_seconds

    rows = []
    for i in range(n):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prof = None
        if i == n - 1:
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
        t0 = time.perf_counter()
        model, state, m = step(model, state, batch)
        loss, tokens = float(m["loss"]), int(m["tokens"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = {"loss": loss, "tokens": tokens, "wall_s": wall,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if prof is not None:
            prof.stop()
            row["idle"] = 1 - busy_seconds(prof) / wall
            del prof
        rows.append(row)
        log(f"  {label} step {i + 1}: loss {loss:.6f} tokens {tokens} wall {wall:.3f} s peak "
            f"{row['peak_gib']:.2f} GiB" + (f" idle {row['idle']:.3f} (under the profiler)"
                                             if "idle" in row else ""))
    return rows


def phase_sp_pp(run: dict, mesh_records: list) -> dict:
    """Sequence and pipeline parallelism on train_cli's checkpoint (the 7B's
    width, the LLM at 4 layers), over NCCL at world size 1 (torchrun's
    variables set in this process). (a) SP: ``Trainer`` with
    ``TrainConfig(seq_shard=True)`` on ``init_mesh("1x1", "cuda")`` over
    3 steps of train_cli's corpus with the CLI's settings (called directly:
    the CLI refuses ``--seq_shard`` below MODEL = 2, as JAX's does); steps
    1-2's losses ``mesh``'s within 1e-6 relative, step 3's within
    ``kernel_check.close``'s bf16 limit, tokens equal; K3 and K4's forward
    and backward launched; step 3 profiled: its all-gathers and
    reduce-scatters (the dispatcher's ``c10d::`` ranges and the port's
    calls) what the code implies, (6L + 2, 5L) a micro-step and ZeRO-2's
    one all-gather (its gradient reaches the partition during the
    backward, with no reduce-scatter). (b) PP: ``make_pp_train_step`` at 1 stage (``shard_params_pp``,
    ``Zero2(split=pp_split)``) for 2 steps of a text window of
    ``SP_PP_WINDOW`` rows, then ``make_mesh_train_step`` at 1x1 on a fresh
    load of the same checkpoint and the same window: losses within 1e-6
    relative, tokens equal, no point-to-point call, K4 launched. Each run
    prints its steps' walls and peaks and its last step's idle share
    (profiled) beside the run it is held to. With 2 cards also SP at 1x2
    (``train.cli --mesh 1x2 --seq_shard`` under torchrun, this script's
    ``--mesh-worker``) and PP at 2 stages (``--pp-worker``), held to the
    1x1 runs by the bf16 limit. Returns the SP and PP runs' launch counts."""
    import collections

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from livecc_tpu_torch.core.mesh import close_mesh, init_mesh
    from livecc_tpu_torch.data.lmm_dataset import LMMDataset
    from livecc_tpu_torch.models.qwen2_vl.convert import load_checkpoint
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.parallel.pipeline import make_pp_train_step, pp_split, shard_params_pp
    from livecc_tpu_torch.parallel.sharding import Zero2, shard_params
    from livecc_tpu_torch.tools import kernel_check
    from livecc_tpu_torch.tools.profile_stream import busy_seconds
    from livecc_tpu_torch.train.step import (TrainConfig, make_mesh_train_step, make_optimizer,
                                             split_frozen)
    from livecc_tpu_torch.train.trainer import Trainer, TrainerConfig

    flags = run["flags"]
    corpus = flags[flags.index("--annotation_paths") + 1]
    counts = {}
    with torchrun_vars():
        mesh = init_mesh("1x1", "cuda")
        try:
            # (a) SP through the Trainer, with the CLI's settings
            cfg, model = load_checkpoint(run["ckpt"], mesh.device, torch.bfloat16)
            n_layers = cfg.text.num_hidden_layers
            dataset = LMMDataset(annotation_paths=[corpus], tokenizer=run["tokenizer"], cfg=cfg,
                                 video_loader=run["loader"])
            trainer = Trainer(model, cfg, TrainConfig(total_steps=3, freeze_modules=("visual",),
                                                      seq_shard=True),
                              TrainerConfig(output_dir=os.path.join(run["work"], "sp_1x1"),
                                            total_steps=3, accum_steps=2, save_steps=None,
                                            log_steps=1, resume=False),
                              dataset, mesh=mesh)
            window, calls = {}, collections.Counter()
            issued = seq_calls(calls)

            def on_step(step, batch, metrics):
                """Step 3 under the profiler and counted, from the end of step 2."""
                if step in (2, 3):
                    torch.cuda.synchronize()
                if step == 2:
                    window["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                         ProfilerActivity.CUDA])
                    window["prof"].start()
                    issued.__enter__()
                    window["t0"] = time.perf_counter()
                elif step == 3:
                    window["wall"] = time.perf_counter() - window["t0"]
                    issued.__exit__(None, None, None)
                    window["prof"].stop()
                    window["micro"] = batch.accum

            build.reset_launch_counts()
            trainer.train(on_step)
            counts["sp"] = dict(build.launch_counts)
            with open(os.path.join(run["work"], "sp_1x1", "log.jsonl")) as f:
                records = [json.loads(line) for line in f]
            del trainer, model, dataset
            gc.collect()
            torch.cuda.empty_cache()
            for rec, r in zip(records, mesh_records):
                a, b = rec["loss"], r["loss"]
                share = kernel_check.close(torch.tensor([a]), torch.tensor([b]), torch.bfloat16)
                same = "bit-equal" if a == b else f"rel {abs(a - b) / abs(b):.2e}"
                log(f"  SP 1x1 step {rec['step']}: loss {a:.6f} vs mesh {b:.6f} ({same}; "
                    f"{share:.4f} of close's bf16 limit); tokens {rec['tokens']} vs "
                    f"{r['tokens']}; wall {rec['wall_s']:.3f} s vs {r['wall_s']:.3f} s; peak "
                    f"{rec['peak_gib']:.2f} GiB vs {r['peak_gib']:.2f} GiB"
                    + (" (under the profiler, both)" if rec["step"] == 3 else ""))
                if rec["tokens"] != r["tokens"]:
                    raise AssertionError(f"sp step {rec['step']}: tokens {rec['tokens']} vs "
                                         f"{r['tokens']}")
                if rec["step"] <= 2 and not abs(a - b) <= 1e-6 * abs(b):
                    raise AssertionError(f"sp step {rec['step']}: loss {a} is not mesh's {b}")
                if not share <= 1.0:
                    raise AssertionError(f"sp step {rec['step']}: loss {a} vs {b}: {share:.3f}x")
            if [r["step"] for r in records] != [1, 2, 3]:
                raise AssertionError(f"sp: steps {[r['step'] for r in records]}")
            missing = [n for n in TRAIN_KERNELS if counts["sp"].get(n, 0) <= 0]
            if missing:
                raise AssertionError(f"sp: the run never launched {missing}")
            prof = window.pop("prof")
            kinds = collections.Counter()
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("c10d::"):
                    kinds["all_gather" if re.search("all_?gather", e.name) else
                          "reduce_scatter" if "reduce_scatter" in e.name else e.name] += 1
            busy = busy_seconds(prof)
            del prof
            micro = window["micro"]
            want = {"all_gather": (6 * n_layers + 2) * micro + 1,
                    "reduce_scatter": 5 * n_layers * micro}
            log(f"  SP step 3 profiled: wall {window['wall']:.3f} s, busy {busy:.3f} s, idle "
                f"share {1 - busy / window['wall']:.3f}; {micro} micro-steps; port calls "
                f"{dict(calls)}, c10d ranges {dict(kinds)}; implied {want}; launches "
                f"{counts['sp']}")
            for op, n in want.items():
                if calls[op] != n or kinds[op] != n:
                    raise AssertionError(f"sp: {op} {calls[op]} calls, {kinds[op]} c10d ranges "
                                         f"in step 3, the code implies {n}")

            # (b) PP at 1 stage, then the mesh step on the same window
            pp = {}
            for label in ("pp", "mesh_step"):
                cfg, model = load_checkpoint(run["ckpt"], mesh.device, torch.bfloat16)
                tcfg = TrainConfig(total_steps=3, freeze_modules=("visual",))
                if label == "pp":
                    shard_params_pp(model, cfg, mesh)
                    zero = Zero2(split_frozen(model, tcfg.freeze_modules)[0], mesh, split=pp_split)
                    step = make_pp_train_step(cfg, tcfg, make_optimizer(tcfg), mesh, zero)
                else:
                    shard_params(model, cfg, mesh, training=True)
                    zero = Zero2(split_frozen(model, tcfg.freeze_modules)[0], mesh)
                    step = make_mesh_train_step(cfg, tcfg, make_optimizer(tcfg), zero)
                batch = pp_window(cfg, mesh.device)
                p2p = collections.Counter()
                build.reset_launch_counts()
                with seq_calls(p2p):
                    pp[label] = profiled_steps(label, step, model, zero.init_state(None), batch, 2)
                launched = dict(build.launch_counts)
                log(f"  {label}: launches {launched}; point-to-point calls "
                    f"{p2p['send'] + p2p['recv']}")
                if label == "pp":
                    counts["pp"] = launched
                    if p2p["send"] or p2p["recv"]:
                        raise AssertionError(f"pp at 1 stage issued point-to-point calls {p2p}")
                if launched.get("train_attention_fwd", 0) <= 0 or \
                        launched.get("train_attention_bwd", 0) <= 0:
                    raise AssertionError(f"{label}: K4 did not launch: {launched}")
                del model, zero, step, batch
                gc.collect()
                torch.cuda.empty_cache()
            for i, (a, b) in enumerate(zip(pp["pp"], pp["mesh_step"])):
                rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
                log(f"  PP step {i + 1}: loss {a['loss']:.6f} vs mesh step {b['loss']:.6f} (rel "
                    f"{rel:.2e}); tokens {a['tokens']} vs {b['tokens']}; wall {a['wall_s']:.3f} s "
                    f"vs {b['wall_s']:.3f} s; peak {a['peak_gib']:.2f} GiB vs "
                    f"{b['peak_gib']:.2f} GiB")
                if a["tokens"] != b["tokens"] or not rel <= 1e-6:
                    raise AssertionError(f"pp step {i + 1}: {a} vs the mesh step's {b}")
            log(f"  last steps' idle share (profiled): PP {pp['pp'][-1]['idle']:.3f}, mesh "
                f"step {pp['mesh_step'][-1]['idle']:.3f}")
        finally:
            close_mesh(mesh)
    if dist.is_initialized():
        raise AssertionError("sp_pp: the process group is still up")

    worlds = [1]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        sout = os.path.join(run["work"], "sp_1x2")
        job = {"work": run["work"], "ffmpeg": run["ffmpeg"],
               "argv": flags + ["--output_dir", sout, "--total_steps", "3", "--save_steps",
                                "100", "--mesh", "1x2", "--seq_shard"]}
        done = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc_per_node", "2", os.path.abspath(__file__),
                               "--mesh-worker", json.dumps(job)],
                              capture_output=True, text=True, timeout=300)
        if done.returncode != 0:
            raise AssertionError(f"sp 1x2: torchrun exited {done.returncode}: "
                                 f"{(done.stdout + done.stderr)[-3000:]}")
        with open(os.path.join(sout, "log.jsonl")) as f:
            other = [json.loads(line) for line in f]
        pjob = {"ckpt": run["ckpt"], "out": os.path.join(run["work"], "pp_2.json")}
        done = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc_per_node", "2", os.path.abspath(__file__),
                               "--pp-worker", json.dumps(pjob)],
                              capture_output=True, text=True, timeout=300)
        if done.returncode != 0:
            raise AssertionError(f"pp 2 stages: torchrun exited {done.returncode}: "
                                 f"{(done.stdout + done.stderr)[-3000:]}")
        with open(pjob["out"]) as f:
            other_pp = json.load(f)
        for label, got, ref in (("sp 1x2", other, records), ("pp 2 stages", other_pp, pp["pp"])):
            for i, (rec, r) in enumerate(zip(got, ref)):
                share = kernel_check.close(torch.tensor([rec["loss"]]), torch.tensor([r["loss"]]),
                                           torch.bfloat16)
                log(f"  {label} step {i + 1}: loss {rec['loss']:.6f} vs 1x1 {r['loss']:.6f} "
                    f"({share:.4f} of close's bf16 limit); wall {rec['wall_s']:.3f} s; peak "
                    f"{rec['peak_gib']:.2f} GiB")
                if rec["tokens"] != r["tokens"] or not share <= 1.0:
                    raise AssertionError(f"{label} step {i + 1}: {rec} vs 1x1 {r}")
        worlds.append(2)
    log(f"  world sizes run: {worlds} ({n_cards} card(s) here; the multi-rank numbers come "
        f"from the CPU tests over gloo)")
    return counts


def pp_worker(spec: str) -> int:
    """One rank of ``phase_sp_pp``'s 2-stage run (``torchrun ...
    chip_smoke.py --pp-worker SPEC``): PP's window for 2 steps; rank 0
    writes the steps' records."""
    sys.path.insert(0, ROOT)
    import torch

    from livecc_tpu_torch.core.mesh import close_mesh, init_mesh
    from livecc_tpu_torch.models.qwen2_vl.convert import load_checkpoint
    from livecc_tpu_torch.parallel.pipeline import make_pp_train_step, pp_split, shard_params_pp
    from livecc_tpu_torch.parallel.sharding import Zero2
    from livecc_tpu_torch.train.step import TrainConfig, make_optimizer, split_frozen

    job = json.loads(spec)
    mesh = init_mesh("1x2", "cuda")
    try:
        cfg, model = load_checkpoint(job["ckpt"], mesh.device, torch.bfloat16)
        tcfg = TrainConfig(total_steps=3, freeze_modules=("visual",))
        shard_params_pp(model, cfg, mesh)
        zero = Zero2(split_frozen(model, tcfg.freeze_modules)[0], mesh, split=pp_split)
        step = make_pp_train_step(cfg, tcfg, make_optimizer(tcfg), mesh, zero)
        rows = profiled_steps(f"pp stage {mesh.m}", step, model, zero.init_state(None),
                              pp_window(cfg, mesh.device), 2)
    finally:
        close_mesh(mesh)
    if mesh.rank == 0:
        with open(job["out"], "w") as f:
            json.dump(rows, f)
    return 0


def mesh_worker(spec: str) -> int:
    """One rank of ``phase_mesh``'s multi-card runs (``torchrun ...
    chip_smoke.py --mesh-worker SPEC``): train_cli's tokenizer and frames
    (``SeededSource`` where FFmpeg is absent), then ``cli.main``."""
    sys.path.insert(0, ROOT)
    from livecc_tpu_torch.data.tokenizer import ByteTokenizer
    from livecc_tpu_torch.tools import train_session as ts
    from livecc_tpu_torch.train import cli

    from livecc_tpu_torch.parallel.sharding import Zero2

    job = json.loads(spec)
    loader = None if job["ffmpeg"] else cli_sources(job["work"]).__getitem__
    real_init = Zero2.__init__

    def init(zero, *args, **kw):
        real_init(zero, *args, **kw)
        print(f"rank {zero.mesh.rank}: ZeRO-2 partition {zero.grad.nbytes} B fp32 ({zero.part} of "
              f"{zero.flat.numel()} elements), bucket {zero.bucket.nbytes} B", flush=True)

    Zero2.__init__ = init
    cli.main(job["argv"], tokenizer=ByteTokenizer.for_config(ts.train_model_config()),
             video_loader=loader)
    return 0


def train_cli_kernels(k4_rows: dict, vit_shapes) -> None:
    """K4 and K3 at train_cli's shapes, on random bf16 inputs: K4's forward
    and backward at each bucket ``S`` of ``k4_rows`` with one causal
    segment of ``k4_rows[S]`` tokens and the pad segment (the bucket's
    longest sample's row), K3 at each (NG, g) of ``vit_shapes``. K4's
    forward and K3 are held to ``kernel_check``'s blocked plain versions by
    ``close`` (a dropped key tile must fail it); K4's backward is held by
    ``grad_close`` to the blocked plain backward
    (``kernel_check.train_attention_bwd_blocked``) in bf16, on the forward
    kernel's o and lse, and in fp32 on the fp32 blocked forward's, and the
    reference with one tile pair dropped (``dropped_tile``) must fail it.
    Times, at the largest S: one call (``cuda_ms``) of kernel, blocked
    plain and SDPA (K4: ``is_causal`` over the real tokens; its backward:
    the gradients of a forward made outside the timing), K4's forward and
    backward and K3 also in device time (``graph_ms``)."""
    import torch

    from livecc_tpu_torch.ops.attention import prescaled
    from livecc_tpu_torch.ops.train_attention import train_attention_bwd, train_attention_fwd
    from livecc_tpu_torch.ops.vit_attention import vit_group_attention
    from livecc_tpu_torch.tools import kernel_check
    from livecc_tpu_torch.tools.kernel_timing import cuda_ms, graph_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    tile = kernel_check.TILE

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    with torch.no_grad():
        for ng, g in vit_shapes:
            h, d = 16, 80
            q, k, v = (randn(ng, g, h, d) for _ in range(3))
            shape = f"NG={ng} g={g} H={h} D={d} bf16 (train_cli)"
            out = vit_group_attention(q, k, v)
            ref = kernel_check.vit_group_attention_blocked(q, k, v)
            qn, kn, vn, rn = (x.reshape(ng * g, h, d) for x in (q, k, v, ref))
            qt = (g - 1) // tile
            fault = kernel_check.vit_drop_key_tile(rn, qn, kn, vn, list(range(0, (ng + 1) * g, g)),
                                                   ng - 1, qt, qt // 2, head=3)
            err = held("vit_group_attention", shape, out, ref, fault.view(ref.shape), True,
                       f"dropped key tile {qt // 2} of query tile {qt}")
            timed_eval("vit_group_attention", shape, err,
                       fns=(lambda: vit_group_attention(q, k, v),
                            lambda: kernel_check.vit_group_attention_blocked(q, k, v)),
                       library=sdpa_eval(q, k, v, None), flops=4 * ng * g * g * h * d,
                       nbytes=4 * ng * g * h * d * 2)
            del q, k, v, out, ref, fault
    hq, hk, d = K4_HEADS
    for s, n_real in sorted(k4_rows.items()):
        timed = s == max(k4_rows)
        qs, k, v, do = prescaled(randn(1, s, hq, d)), randn(1, s, hk, d), randn(1, s, hk, d), \
            randn(1, s, hq, d)
        seg = segment_ids(s, (n_real,), dev)
        shape = (f"B=1 S={s} segment {n_real} + pad {s - n_real} Hq={hq} Hk={hk} D={d} bf16 "
                 f"(train_cli)")
        pairs = causal_pairs((n_real,), s)
        io = 2 * (2 * s * hq * d + 2 * s * hk * d)
        qt = n_real // tile - 1
        with torch.no_grad():
            o, lse = train_attention_fwd(qs, k, v, seg)
            ro, rlse = kernel_check.train_attention_fwd_blocked(qs, k, v, seg)
            bad, _ = kernel_check.dropped_fwd_tile(qs, k, v, seg, ro, rlse, qt, qt // 2, 3)
            err = held("train_attention_fwd", shape, o, ro, bad, True,
                       f"dropped key tile {qt // 2} of query tile {qt}")
            del ro, rlse, bad
            if timed:
                timed_eval("train_attention_fwd", shape, err,
                           fns=(lambda: train_attention_fwd(qs, k, v, seg),
                                lambda: kernel_check.train_attention_fwd_blocked(qs, k, v, seg)),
                           library=sdpa_eval(qs[:, :n_real], k[:, :n_real], v[:, :n_real], True),
                           flops=4 * pairs * d * hq, nbytes=io + 4 * s * hq + 4 * s)
            # the backward against the blocked plain backward, bf16 and fp32
            grads = train_attention_bwd(qs, k, v, seg, o, lse, do)
            ref = kernel_check.train_attention_bwd_blocked(qs, k, v, seg, o, lse, do)
            f32 = [x.float() for x in (qs, k, v)]
            ref32 = kernel_check.train_attention_bwd_blocked(
                *f32, seg, *kernel_check.train_attention_fwd_blocked(*f32, seg), do.float())
            del f32
            fault = kernel_check.dropped_tile(qs, k, v, seg, do, o, lse, ref, qt, qt // 2, 3)[2:]
            torch.cuda.synchronize()
            for part, out, r, r32, bad in zip(("dq", "dk", "dv"), grads, ref, ref32, fault):
                w, w_bad = (kernel_check.grad_close(x, r, r32) for x in (out, bad))
                err = (out.float() - r.float()).abs().max().item()
                log(f"  {'train_attention_bwd':20s} {shape} {part}: max_abs_err {err:.3e}, worst "
                    f"{w:.3f} of grad_close's limit against the blocked plain backward; a "
                    f"dropped tile pair ({qt}, {qt // 2}): {w_bad:.2f}x")
                if not w <= 1.0:
                    raise AssertionError(f"train_attention_bwd {shape} {part}: {w:.3f}x the limit")
                if not w_bad > 1.0:
                    raise AssertionError(f"train_attention_bwd {shape} {part}: the check passes "
                                         f"a dropped tile pair")
            del grads, ref, ref32, fault
            torch.cuda.empty_cache()
        if timed:
            ms = cuda_ms(lambda: train_attention_bwd(qs, k, v, seg, o, lse, do))
            dev_ms = graph_ms(lambda: train_attention_bwd(qs, k, v, seg, o, lse, do))
            plain_ms = cuda_ms(lambda: kernel_check.train_attention_bwd_blocked(
                qs, k, v, seg, o, lse, do), iters=3, warmup=1)
            lib_ms = cuda_ms(sdpa_eval(qs[:, :n_real], k[:, :n_real], v[:, :n_real], True,
                                       do[:, :n_real]))
            b_ms, b_by = bound(10 * pairs * d * hq,
                               io + 2 * s * hq * d + 3 * (2 * s * hk * d) + 4 * s * hq + 4 * s)
            log(f"  {'train_attention_bwd':20s} {shape}: one call: kernel {ms:.4f} (device "
                f"{dev_ms:.4f})  blocked plain "
                f"{plain_ms:.4f}  SDPA is_causal backward over the {n_real} real tokens "
                f"{lib_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}; "
                f"{10 * pairs * d * hq / 1e12:.4f} TFLOP); causal pairs {pairs}")
        del qs, k, v, do, o, lse
        torch.cuda.empty_cache()


def remat_ab(cfg, ckpt: str, sample: dict, checked: dict) -> None:
    """``phase_train_cli``'s remat A/B and profiled micro-step on the
    checkpoint's bf16 weights and one 32768-bucket micro-batch
    (``sample``). Each policy's forward and backward: wall, peak memory,
    the loss (bit-equal to remat=True's) and the gradients of the
    ``checked`` tensors, bit-equal to remat=True's (the named policies'
    regions keep remat=True's backward graph) or, where not, held to them by
    ``kernel_check.grad_close`` against the same micro-step in fp32 (the
    model cast to fp32, fp32 logit rows), which tells bf16 roundings in
    another order from an error. One micro-step under remat=True is
    profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from livecc_tpu_torch.models.qwen2_vl.convert import load_checkpoint
    from livecc_tpu_torch.tools import kernel_check
    from livecc_tpu_torch.tools import train_session as ts
    from livecc_tpu_torch.tools.profile_stream import busy_seconds, device_groups
    from livecc_tpu_torch.train.data import collate
    from livecc_tpu_torch.train.step import TrainConfig, loss_fn, split_frozen

    _, model = load_checkpoint(ckpt, "cuda", torch.bfloat16)
    batch = collate([sample], cfg, device="cuda")
    micro = batch.micro(0)
    flops, tokens = ts.window_flops(cfg, batch)

    def fwd_bwd(remat, **kw):
        """(loss, wall s, peak GiB, the checked gradients) of one micro-step."""
        tcfg = TrainConfig(remat=remat, **kw)
        split_frozen(model, tcfg.freeze_modules)
        for p in model.parameters():
            p.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = loss_fn(model, cfg, tcfg, micro)
        loss.backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        params = dict(model.text.named_parameters())
        grads = {n: params[n].grad for n in checked}
        for p in model.parameters():
            p.grad = None
        return loss.detach(), wall, torch.cuda.max_memory_allocated() / 2**30, grads

    fwd_bwd(True)                           # warm-up
    runs = {remat: fwd_bwd(remat) for remat in CLI_REMATS}
    # one profiled micro-step under remat=True
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall, _, _ = fwd_bwd(True)
    busy = busy_seconds(prof)
    groups = device_groups(prof)
    device = sum(groups.values())
    k4 = groups.get("K4 train_attention_fwd", 0.0) + groups.get("K4 train_attention_bwd", 0.0)
    log(f"  profiled micro-step ({tokens} tokens in the {batch.input_ids.shape[-1]} bucket, "
        f"remat=True): wall {wall:.3f} s, device busy {busy:.3f} s, idle share "
        f"{1 - busy / wall:.3f}, model {flops / wall / 1e12:.1f} TFLOP/s; K4 "
        f"{k4 / device:.1%} of device time")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:28s} {t * 1e3:10.2f} ms  {t / device:6.1%}")
    del prof
    ref_loss, _, _, ref = runs[True]
    ref32 = None
    for remat, (loss, wall, peak, grads) in runs.items():
        same = [n for n, g in grads.items() if torch.equal(g, ref[n])]
        note = ""
        if len(same) < len(grads):
            if ref32 is None:               # the fp32 reference of the gradients
                model.float()
                _, wall32, peak32, ref32 = fwd_bwd(True, ce_logits="f32")
                log(f"  fp32 reference micro-step (remat=True): wall {wall32:.3f} s  peak "
                    f"{peak32:.2f} GiB")
            worst = max(kernel_check.grad_close(grads[n], ref[n], ref32[n])
                        for n in grads if n not in same)
            note = f", the others' worst grad_close {worst:.3f}"
            if not worst <= 1.0:
                raise AssertionError(f"train_cli remat={remat!r}: gradients {worst:.3f}x "
                                     f"grad_close's limit")
        log(f"  remat={remat!r:12s} micro-step fwd+bwd: wall {wall:.3f} s  peak {peak:.2f} GiB  "
            f"loss {loss.item():.6f}; {len(same)} of {len(grads)} checked gradients bit-equal "
            f"to remat=True's{note}")
        if not torch.equal(loss, ref_loss):
            raise AssertionError(f"train_cli remat={remat!r}: loss {loss.item()} is not "
                                 f"remat=True's {ref_loss.item()}")
    del model, batch, micro, runs, ref32


# ---------------------------------------------------------------------------
# data production: ASR, the corpus scorers, the Live-CC JSONL
# ---------------------------------------------------------------------------

def phase_tiny_asr():
    """The tiny Whisper in fp32 (weights drawn on the CPU from a seed): the
    CPU and the card give identical greedy tokens on three seeded mels, once
    to EOS and once with EOS out of reach (to the clamp)."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from livecc_tpu_torch.models import whisper as pw

    cfg = pw.tiny_whisper_config()
    cpu = pw.init_whisper(cfg, torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to("cuda")
    for c in (cfg, dataclasses.replace(cfg, eos_token_id=-1)):
        for seed in range(3):
            mel = np.random.RandomState(seed).randn(
                c.num_mel_bins, 2 * c.max_source_positions).astype(np.float32)
            want = pw.greedy_transcribe_tokens(cpu, c, mel, [c.decoder_start_token_id])
            got = pw.greedy_transcribe_tokens(gpu, c, mel, [c.decoder_start_token_id])
            if got != want or not got:
                raise AssertionError(f"tiny asr seed {seed}: CPU {want} and GPU {got} differ")
        log(f"  tiny whisper, eos {c.eos_token_id}: CPU and GPU tokens identical on 3 mels "
            f"(last: {len(got)} tokens)")


def asr_decode_text(ids) -> str:
    """The asr phase's ``decode_text``: token id i is the word
    ``CLI_VOCAB[i % len(CLI_VOCAB)]``."""
    return " ".join(CLI_VOCAB[i % len(CLI_VOCAB)] for i in ids)


def rel_err(a, b) -> float:
    """||a - b|| / ||b|| in fp32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def phase_asr() -> list:
    """Whisper large-v3-turbo (``WhisperConfig()``: 32 encoder and 4
    decoder layers of d 1280) through ``tools/asr.py:WhisperTranscriber``.
    fp32 weights drawn on the card from seed ``ASR_SEED`` are written under
    build/ as an HF checkpoint (``save_whisper_checkpoint``) and loaded back
    by the transcriber in bf16 on the card; ``ASR_SECONDS`` s of seeded PCM
    reach it through its ``audio_loader`` (this machine may have no FFmpeg),
    in segments of 30 s. Random weights seldom reach EOS, so a segment
    decodes to the 447-token cap, the worst case. Checks words in every
    segment, spans in order, and the bf16 encoder states and first-step
    logits of segment 0 within ``ASR_REL_TOL`` of the same checkpoint in
    fp32 on the card. Prints the wall, each segment's encode and decode
    seconds and tokens, the real-time factor and the peak device memory.
    Returns the words."""
    import shutil

    import numpy as np
    import torch

    from livecc_tpu_torch.audio.mel import SAMPLE_RATE, log_mel_spectrogram
    from livecc_tpu_torch.models import whisper as pw
    from livecc_tpu_torch.models.whisper import model as whisper_model
    from livecc_tpu_torch.models.whisper.model import decoder_hidden, lm_logits
    from livecc_tpu_torch.tools.asr import WhisperTranscriber
    from livecc_tpu_torch.tools.checkpoint import save_whisper_checkpoint

    cfg = pw.WhisperConfig()
    ckpt = os.path.join(ROOT, "build", "asr_whisper")
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    model = pw.init_whisper(cfg, torch.Generator(device="cuda").manual_seed(ASR_SEED), "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    file = save_whisper_checkpoint(model, cfg, ckpt)
    del model
    log(f"  large-v3-turbo: {n_params / 1e6:.1f} M params drawn and written as fp32 "
        f"({os.path.getsize(file) / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s")
    pcm = (np.random.RandomState(ASR_SEED).randn(ASR_SECONDS * SAMPLE_RATE) * 0.1).astype(
        np.float32)

    def audio_loader(path, sr):
        if sr != SAMPLE_RATE:
            raise ValueError(f"asked for {sr} Hz")
        return pcm

    t0 = time.perf_counter()
    tr = WhisperTranscriber(ckpt, audio_loader=audio_loader, decode_text=asr_decode_text)
    torch.cuda.synchronize()
    log(f"  loaded in bf16 on the card in {time.perf_counter() - t0:.1f} s")
    # each segment's greedy call, and the encoder call inside it
    segments, encodes = [], []
    originals = pw.greedy_transcribe_tokens, whisper_model.whisper_encode
    timed_calls(pw, "greedy_transcribe_tokens", segments)
    timed_calls(whisper_model, "whisper_encode", encodes)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    try:
        t0 = time.perf_counter()
        words = tr("match.mp4")
        wall = time.perf_counter() - t0
    finally:
        pw.greedy_transcribe_tokens, whisper_model.whisper_encode = originals
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    n_seg = -(-ASR_SECONDS // 30)
    for i, ((seg_s, tokens), (enc_s, _)) in enumerate(zip(segments, encodes)):
        log(f"  segment {i}: encode {enc_s:.3f} s, decode {seg_s - enc_s:.3f} s for "
            f"{len(tokens)} tokens ({(seg_s - enc_s) / len(tokens) * 1e3:.2f} ms a step)")
    log(f"  {ASR_SECONDS} s of audio: wall {wall:.3f} s, real-time factor {wall / ASR_SECONDS:.4f}, "
        f"{len(words)} words, {sum(len(t) for _, t in segments)} tokens; peak device memory "
        f"{peak:.2f} GiB above what the card held before the call (the 7B and the "
        f"transcriber's weights)")
    per_seg = [[w for w in words if i * 30 <= w[0] < (i + 1) * 30] for i in range(n_seg)]
    if len(segments) != n_seg or not all(per_seg) or any(
            a[1] > b[0] + 1e-6 for a, b in zip(words, words[1:])):
        raise AssertionError(f"asr: {len(segments)} segments, words per segment "
                             f"{[len(x) for x in per_seg]}")
    mel = torch.from_numpy(log_mel_spectrogram(pcm[:30 * SAMPLE_RATE], cfg.num_mel_bins))[None]
    ref = pw.load_safetensors_dir(ckpt, cfg, "cuda", torch.float32)
    with torch.no_grad():
        ids = torch.zeros(1, 8, dtype=torch.long, device="cuda")
        ids[0, 0] = cfg.decoder_start_token_id
        outs = []
        for m in (tr.model, ref):
            enc = pw.whisper_encode(m, cfg, mel)
            outs.append((enc, lm_logits(m, decoder_hidden(m, cfg, ids, enc)[:, 0])))
    errs = [rel_err(a, b) for a, b in zip(*outs)]
    first = [int(o[1].argmax()) for o in outs]
    log(f"  bf16 against fp32 (segment 0): encoder states {errs[0]:.4f}, first-step logits "
        f"{errs[1]:.4f} (||bf16 - fp32|| / ||fp32||; limit {ASR_REL_TOL}); first token "
        f"{first[0]} / {first[1]}")
    if not max(errs) <= ASR_REL_TOL:
        raise AssertionError(f"asr: bf16 strays {errs} from fp32, limit {ASR_REL_TOL}")
    del tr, ref, outs, segments, encodes
    shutil.rmtree(ckpt)
    return words


def lmm_source(path: str) -> "SeededSource":
    """The produce phase's clips: ``LMM_SECONDS`` s of ``LMM_SOURCE_HW`` at
    ``LMM_FPS``, seeded by the clip's number (``clip<i>.mp4``)."""
    i = int(os.path.basename(path)[4:-4])
    return SeededSource(int(LMM_SECONDS * LMM_FPS), LMM_FPS, LMM_SOURCE_HW, 100 + i)


def lm_loss_samples():
    """``len(LM_LOSS_CHARS)`` lm_loss rows: a title or the previous
    transcript as context, a transcript of CLI_VOCAB words of about that
    many characters."""
    import numpy as np

    rng = np.random.RandomState(7)
    rows = []
    for i, n in enumerate(LM_LOSS_CHARS):
        words = []
        while sum(len(w) + 1 for w in words) < n:
            words.append(str(rng.choice(CLI_VOCAB)))
        ctx = {"title": f"Match {i}"} if i % 2 else {"previous": "the keeper saves and the"}
        rows.append({**ctx, "transcript": " ".join(words)})
    return rows


def profiled(fn):
    """(fn's result, wall seconds, device busy seconds, device seconds by
    group) of one call under the profiler."""
    import torch

    from livecc_tpu_torch.tools import profile_stream

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, profile_stream.busy_seconds(prof), profile_stream.device_groups(prof)


def log_profile(label: str, wall: float, busy: float, groups: dict) -> None:
    total = sum(groups.values())
    log(f"  {label} profiled: wall {wall:.3f} s, device busy {busy:.3f} s, idle share "
        f"{1 - busy / wall:.3f}")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:28s} {t * 1e3:10.2f} ms  {t / total:6.1%} of device time")


def phase_produce(cfg, model, words: list) -> tuple[dict, dict, dict]:
    """The corpus scorers on main's 7B (bf16, full depth) and the Live-CC
    JSONL: ``TalkingHeadPredictor`` (8 frames of each clip as images at
    smart_resize(320, 180)) over ``LMM_CLIPS`` seeded clips at batch
    ``LMM_BATCH``, then at batch 1 on ``LMM_SINGLE`` of them (within
    ``LMM_LOG_TOL`` of the batched P('Yes') in log space), then the batch
    again under the profiler (bit-equal); ``lm_loss_scores`` on
    ``lm_loss_samples()`` (1000-2048 tokens), and again under the profiler
    (bit-equal). The asr phase's words then go through
    ``clips_for_pretrain`` -> ``to_conversation`` -> ``write_corpus`` and
    the port's ``LMMDataset`` reads the first row back (its labelled text
    holds the clip's words). Last, K3 and K4's forward at these shapes
    (``produce_kernels``). Returns the predictor's and lm_loss's launch
    counts, and the kernel results."""
    import tempfile

    import numpy as np
    import torch

    from livecc_tpu_torch.data import chat
    from livecc_tpu_torch.data.lmm_dataset import LMMDataset
    from livecc_tpu_torch.data.tokenizer import ByteTokenizer
    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import filters, lmm4asd, production

    tok = ByteTokenizer.for_config(cfg)
    videos = [f"clip{i}.mp4" for i in range(LMM_CLIPS)]
    pred = lmm4asd.TalkingHeadPredictor(model, cfg, tok, batch_size=LMM_BATCH,
                                        video_loader=lmm_source)
    flushes = []
    timed_calls(pred, "_flush", flushes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2**30
    build.reset_launch_counts()
    t0 = time.perf_counter()
    probs = pred.predict_probs(videos)
    wall = time.perf_counter() - t0
    lmm_counts = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**30 - held_gib
    enc = pred.encode(pred._read(videos[0]))
    n_real = enc["ids"].shape[1]
    s = 1 << (n_real - 1).bit_length()
    grid = enc["grids"][0]
    log(f"  lmm4asd: {LMM_CLIPS} clips at batch {LMM_BATCH}: wall {wall:.3f} s ({LMM_CLIPS / wall:.2f} "
        f"clips/s; host {wall - sum(f for f, _ in flushes):.3f} s, forward "
        f"{sum(f for f, _ in flushes):.3f} s), "
        f"peak device memory {peak:.2f} GiB above the model's; a row {n_real} tokens in the {s} "
        f"bucket, {pred.num_frames} images of grid {grid} ({LMM_CLIPS * pred.num_frames} ViT "
        f"groups of g = {grid[1] * grid[2]}); launches {lmm_counts}")
    log(f"  P('Yes'): min {probs.min():.3e} median {np.median(probs):.3e} max {probs.max():.3e}")
    missing = [k for k in PRODUCE_KERNELS if lmm_counts.get(k, 0) <= 0]
    if missing or lmm_counts.get("train_attention_bwd") or not ((probs > 0) & (probs < 1)).all():
        raise AssertionError(f"lmm4asd: launches {lmm_counts}, probabilities {probs}")
    single = lmm4asd.TalkingHeadPredictor(model, cfg, tok, batch_size=1, video_loader=lmm_source)
    one = single.predict_probs(videos[:LMM_SINGLE])
    dev = np.abs(np.log(one) - np.log(probs[:LMM_SINGLE]))
    log(f"  batch 1 against batch {LMM_BATCH} on {LMM_SINGLE} clips: |ln p1 - ln p64| "
        f"{[round(float(x), 4) for x in dev]} (limit {LMM_LOG_TOL})")
    if not dev.max() <= LMM_LOG_TOL:
        raise AssertionError(f"lmm4asd: batch 1 parts from batch {LMM_BATCH}: {dev}")
    again, p_wall, busy, groups = profiled(lambda: pred.predict_probs(videos))
    if not np.array_equal(again, probs):
        raise AssertionError("lmm4asd: a second run of the batch differs")
    log_profile(f"lmm4asd batch of {LMM_CLIPS}", p_wall, busy, groups)

    samples = lm_loss_samples()
    lens = [len(tok.encode(chat.render_chat([
        {"role": "user", "content": [{"type": "text", "text": x.get("previous") or x["title"]}]},
        {"role": "assistant", "content": [{"type": "text", "text": x["transcript"]}]}])))
        for x in samples]
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = filters.lm_loss_scores(model, cfg, tok, samples)
    wall = time.perf_counter() - t0
    loss_counts = dict(build.launch_counts)
    log(f"  lm_loss: {len(samples)} samples of {min(lens)}-{max(lens)} tokens: "
        f"{wall / len(samples):.3f} s a sample; scores {np.round(scores, 3).tolist()}, keep "
        f"{filters.lm_loss_keep(scores).tolist()}; launches {loss_counts}")
    if (not np.isfinite(scores).all() or loss_counts.get("train_attention_fwd", 0) <= 0
            or not 1000 <= min(lens) <= max(lens) <= 2048):
        raise AssertionError(f"lm_loss: scores {scores}, lengths {lens}, launches {loss_counts}")
    again, p_wall, busy, groups = profiled(lambda: filters.lm_loss_scores(model, cfg, tok,
                                                                          samples))
    if not np.array_equal(again, scores):
        raise AssertionError("lm_loss: a second run differs")
    log_profile(f"lm_loss {len(samples)} samples", p_wall, busy, groups)

    clips = production.clips_for_pretrain(words)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        corpus = os.path.join(tmp, "asr_corpus.jsonl")
        production.write_corpus([production.to_conversation("match.mp4", c, CLI_QUERY,
                                                            title="Match") for c in clips], corpus)
        source = SeededSource(int(ASR_SECONDS * CLI_SOURCE_FPS), CLI_SOURCE_FPS, CLI_SOURCE_HW,
                              ASR_SEED)
        ds = LMMDataset(annotation_paths=[corpus], tokenizer=tok, cfg=cfg,
                        video_loader=lambda path: source)
        x = ds.getitem(0)
    labelled = tok.decode(x["input_ids"][0][x["labels"][0] != -100].tolist())
    first = [w for _, _, w in clips[0]["words"][:5]]
    log(f"  corpus: {len(words)} words -> {len(clips)} clips "
        f"{[(c['start'], c['end'], len(c['words'])) for c in clips]}; row 0 read back: "
        f"{x['input_ids'].shape[1]} tokens, {len(x['video_grid_thw'])} frame groups of "
        f"{x['video_grid_thw'][-1].tolist()}, labelled text "
        f"starts {labelled[:60]!r}")
    if not clips or len(ds) != len(clips) or " ".join(first) not in labelled:
        raise AssertionError(f"produce corpus: {len(clips)} clips, {len(ds)} rows, words "
                             f"{first} not in {labelled[:200]!r}")
    results = produce_kernels(n_real, pred.num_frames * LMM_CLIPS, grid[1] * grid[2],
                              max(lens))
    return lmm_counts, loss_counts, results


def produce_kernels(n_row: int, ng: int, g: int, n_loss: int) -> dict:
    """K3 at lmm4asd's shape (``ng`` groups of ``g``, H 16, D 80) and K4's
    forward at its batch (B ``LMM_BATCH``, rows of ``n_row`` tokens padded to
    their power-of-two bucket, pads as segment 0) and at lm_loss's longest
    sample (B 1, ``n_loss`` tokens in their bucket), bf16 random inputs:
    each against ``kernel_check``'s blocked plain version by ``held``,
    which a dropped key tile must fail; two launches bit-equal; kernel,
    blocked plain and SDPA timed (``timed_eval``) beside the bound."""
    import torch

    from livecc_tpu_torch.core.config import ModelConfig
    from livecc_tpu_torch.ops.train_attention import train_attention_fwd
    from livecc_tpu_torch.ops.vit_attention import vit_group_attention
    from livecc_tpu_torch.tools import kernel_check

    cfg = ModelConfig.qwen2_vl_7b()
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(16)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    def bit_equal(name, fn):
        a, b = fn(), fn()
        same = all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple) \
            else torch.equal(a, b)
        if not same:
            raise AssertionError(f"{name}: two launches differ")

    results = {}
    with torch.inference_mode():
        h, d = cfg.vision.num_heads, cfg.vision.head_dim
        q, k, v = (randn(ng, g, h, d) for _ in range(3))
        shape = f"NG={ng} g={g} H={h} D={d} bf16 (lmm4asd)"
        err = vit_held(q, k, v, shape, True)
        bit_equal("vit_group_attention " + shape, lambda: vit_group_attention(q, k, v))
        results["vit_group_attention"] = timed_eval(
            "vit_group_attention", shape, err,
            fns=(lambda: vit_group_attention(q, k, v),
                 lambda: kernel_check.vit_group_attention_blocked(q, k, v)),
            library=sdpa_eval(q, k, v, None), flops=4 * ng * g * g * h * d,
            nbytes=4 * ng * g * h * d * 2)
        del q, k, v
        hq, hk, d = (cfg.text.num_attention_heads, cfg.text.num_key_value_heads,
                     cfg.text.head_dim)
        rows = []
        for b, n_real, what in ((LMM_BATCH, n_row, "lmm4asd"), (1, n_loss, "lm_loss")):
            s = 1 << (n_real - 1).bit_length()
            qs = randn(b, s, hq, d) * d ** -0.5
            k, v = randn(b, s, hk, d), randn(b, s, hk, d)
            seg = torch.zeros(b, s, dtype=torch.int32, device=dev)
            seg[:, :n_real] = 1
            shape = (f"B={b} S={s} segment {n_real} + pad {s - n_real} Hq={hq} Hk={hk} D={d} "
                     f"bf16 ({what})")
            err = k4_fwd_held(qs, k, v, seg, n_real, shape, True)
            bit_equal("train_attention_fwd " + shape, lambda: train_attention_fwd(qs, k, v, seg))
            pairs = causal_pairs((n_real,), s)
            rows.append(timed_eval(
                "train_attention_fwd", shape, err,
                fns=(lambda: train_attention_fwd(qs, k, v, seg),
                     lambda: kernel_check.train_attention_fwd_blocked(qs, k, v, seg)),
                library=sdpa_eval(qs[:, :n_real], k[:, :n_real], v[:, :n_real], True),
                flops=4 * b * pairs * d * hq,
                nbytes=b * (2 * (2 * s * hq * d + 2 * s * hk * d) + 4 * s * hq + 4 * s)))
            pad = causal_pairs((), s - n_real)
            log(f"  {'train_attention_fwd':20s} {what}: causal pairs a row {pairs} (pad {pad}, "
                f"a {pad / pairs:.3f} share of the work); SDPA is_causal over the real tokens")
            del qs, k, v, seg
            torch.cuda.empty_cache()
        results["train_attention_fwd"] = rows
    return results


def asd_video():
    """The asd phase's 5-minute video and audio: ``ASD_SECONDS`` s of
    ``ASD_HW`` frames at ``ASD_FPS`` (uint8 [T, H, W, 3]; a seeded still
    scene, a smooth shading plus texture, and per-frame noise of up to
    ``ASD_NOISE`` grey levels, each frame one of 64 noise fields drawn at
    random) and 16 kHz PCM (a voice-band tone under noise)."""
    import numpy as np

    rng = np.random.default_rng(ASD_SEED)
    h, w = ASD_HW
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    shade = 110 + 60 * np.sin(xx / 23.0)[..., None] * np.cos(yy / 17.0)[..., None] \
        * np.asarray([1.0, 0.8, 0.6], np.float32)
    scene = np.clip(shade + rng.normal(0, 25, (h, w, 3)), 0, 255 - ASD_NOISE).astype(np.uint8)
    noise = rng.integers(0, ASD_NOISE + 1, (64, h, w, 3), dtype=np.uint8)
    frames = np.empty((ASD_SECONDS * ASD_FPS, h, w, 3), np.uint8)
    for i, k in enumerate(rng.integers(0, len(noise), len(frames))):
        np.add(scene, noise[k], out=frames[i])
    t = np.arange(ASD_SECONDS * ASD_SR, dtype=np.float32) / ASD_SR
    audio = (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t))
             + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    return frames, audio


def threshold_bias(scores) -> float:
    """The score bias that puts about ``ASD_FACES`` of ``scores`` (a
    frame's anchors' sigmoid scores at bias 0) above the threshold of 0.5:
    the midpoint of the ``ASD_FACES``-th and next logits, negated (random
    weights find no face at a plain bias)."""
    import numpy as np

    s = np.asarray(scores, np.float64)
    logits = np.sort(np.log(s / (1 - s)))[::-1]
    return -float(logits[ASD_FACES - 1] + logits[ASD_FACES]) / 2


def asd_graph(path: str, frame) -> float:
    """Write the asd phase's detector graph to ``path``
    (``scrfd_synth.synth_scrfd_onnx`` at ``ASD_GRAPH_CH``, seed
    ``ASD_SEED``, box bias ``ASD_BOX_BIAS``) with the score bias
    ``threshold_bias`` finds for ``frame`` on the CPU; returns the bias."""
    import numpy as np
    import torch

    from livecc_tpu_torch.tools import onnx_lite, onnx_torch, scrfd_synth

    def graph(bias):
        return scrfd_synth.synth_scrfd_onnx(ch=ASD_GRAPH_CH, seed=ASD_SEED, score_bias=bias,
                                            bbox_bias=ASD_BOX_BIAS)

    fn = onnx_torch.build_fn(graph(0.0), "cpu")
    x = torch.from_numpy(((frame.astype(np.float32) - 127.5) / 128.0).transpose(2, 0, 1)[None]
                         .copy())
    with torch.inference_mode():
        bias = threshold_bias(np.concatenate([o.numpy().ravel() for o in fn(x)[:3]]))
    onnx_lite.save_model(path, graph(bias))
    return bias


def asd_tubes(feats, record=None, scorer=None):
    """``score_track`` for ``asd.talking_ratio`` (after
    tests/test_aux_tools.py:254-270): each track's 112x112 grayscale face
    tube, raw 0..255 as ``lightasd.py`` asks, and its MFCC rows from the
    track's first frame (4 a frame), through ``scorer(faces, mfcc)``
    (default 0.0). ``record`` gets (frames, boxes, host seconds) of each."""
    import numpy as np

    def score_track(track, frames):
        t0 = time.perf_counter()
        h_f, w_f = frames.shape[1], frames.shape[2]
        tube = []
        for fi, box in zip(track.frames, track.boxes):
            x1, y1, x2, y2 = [int(v) for v in box]
            x1 = min(max(x1, 0), w_f - 1)
            y1 = min(max(y1, 0), h_f - 1)
            x2 = min(max(x2, x1 + 1), w_f)
            y2 = min(max(y2, y1 + 1), h_f)
            crop = frames[fi, y1:y2, x1:x2].mean(axis=-1)
            yy = np.linspace(0, crop.shape[0] - 1, 112).astype(int)
            xx = np.linspace(0, crop.shape[1] - 1, 112).astype(int)
            tube.append(crop[np.ix_(yy, xx)])
        faces = np.stack(tube).astype(np.float32)
        lo = 4 * track.frames[0]
        mfcc = feats[lo:lo + 4 * len(faces)]
        if record is not None:
            record.append((list(track.frames), np.stack(track.boxes), time.perf_counter() - t0))
        return scorer(faces, mfcc) if scorer else 0.0

    return score_track


def same_detections(label: str, gpu: list, cpu: list, near: list) -> int:
    """Per frame (boxes, scores) of the card and of the CPU: equal counts,
    boxes within 1e-3 px and scores within ``ASD_SCORE_TOL``, but on frames
    where ``near`` (anchors whose CPU score lies within ``ASD_SCORE_TOL`` of
    the threshold) is non-zero, where a part is reported. Returns the
    frames reported."""
    import numpy as np

    reported = 0
    for i, ((gb, gs), (cb, cs), n) in enumerate(zip(gpu, cpu, near)):
        same = len(gb) == len(cb) and np.allclose(gb, cb, rtol=0, atol=1e-3) \
            and np.allclose(gs, cs, rtol=0, atol=ASD_SCORE_TOL)
        if not same:
            if not n:
                raise AssertionError(f"{label} frame {i}: card {len(gb)} boxes {gb} {gs}, CPU "
                                     f"{len(cb)} boxes {cb} {cs}, no score near the threshold")
            reported += 1
            log(f"  {label} frame {i}: the card's boxes part from the CPU's ({len(gb)} against "
                f"{len(cb)}) with {n} CPU scores within {ASD_SCORE_TOL} of the threshold: "
                "reported, not counted")
    return reported


def phase_asd() -> None:
    """The active-speaker filter (``tools/{asd,scrfd,lightasd,onnx_torch}.py``)
    over a 5-minute video at the reference's decode size (``asd_video``:
    7,500 frames of 160x288 at 25 fps; 300 s of 16 kHz PCM through
    ``asd.mfcc``). The detector is ``scrfd.load_onnx_detector`` on the
    seeded 44-node test graph written by the port's ``onnx_lite``
    (``asd_graph``) at ``ScrfdConfig``'s threshold; Light-ASD
    (``lightasd.make_lightasd``, seeded weights) scores the tubes
    (``asd_tubes``). Checks, GPU against CPU: the first window's raw outputs
    within ``ASD_RAW_TOL``, its boxes and tracks (``same_detections``); the
    detector at ``ScrfdConfig``'s defaults through ``make_detector`` on
    ``ASD_MAKE_FRAMES`` frames (raw outputs within ``ASD_RAW_TOL``, equal
    boxes, at least one); one planted 150-frame tube's logits within
    ``ASD_LOGIT_TOL``. Then ``asd.talking_ratio`` over the whole video on
    the card (wall split into host and device calls through
    ``detect_faces.levels``, tracks, tubes, the ratio, peak memory), 10
    planted tubes (one a window: faces [150, 112, 112], MFCC [600, 13])
    through ``lightasd.track_score``, the detector's and Light-ASD's times
    by CUDA events and under the profiler, and one window profiled
    (``profile_stream.report``)."""
    import tempfile

    import numpy as np
    import torch

    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import (asd, kernel_timing, lightasd, onnx_lite, onnx_torch,
                                        profile_stream, scrfd)

    t0 = time.perf_counter()
    frames, audio = asd_video()
    feats = asd.mfcc(audio, ASD_SR).astype(np.float32)
    windows = asd.window_indices(len(frames))
    log(f"  video: {frames.shape} uint8 ({frames.nbytes / 2**30:.2f} GiB), {len(windows)} windows "
        f"of 150 frames every 750 ({sum(b - a for a, b in windows)} detector frames); audio "
        f"{len(audio) / ASD_SR:.0f} s -> MFCC {feats.shape}; made in "
        f"{time.perf_counter() - t0:.1f} s")
    if len(windows) != 10 or frames.shape[1:3] != ASD_HW:
        raise AssertionError(f"asd: windows {windows}, frames {frames.shape}")
    cfg = scrfd.ScrfdConfig()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "det_buffalo_sc_layout.onnx")
        bias = asd_graph(path, frames[0])
        model = onnx_lite.load_model(path)
        det_gpu = scrfd.load_onnx_detector(path, cfg)
        det_cpu = scrfd.load_onnx_detector(path, cfg, "cpu")
    log(f"  detector graph: {len(model.nodes)} nodes, "
        f"{sum(a.size for a in model.initializers.values())} initializer values (ch "
        f"{ASD_GRAPH_CH}), score bias {bias:.4f}, box bias {ASD_BOX_BIAS}")
    fwd = {d: onnx_torch.build_fn(model, d) for d in ("cuda", "cpu")}

    def raw(d, frame):
        x = torch.as_tensor(frame).to(d)
        x = ((x.to(torch.float32) - 127.5) / 128.0).permute(2, 0, 1)[None]
        with torch.inference_mode():
            return np.concatenate([o.cpu().numpy().ravel() for o in fwd[d](x)])

    def raw_err(g, c) -> float:
        return float((np.abs(g - c) / (1 + np.abs(c))).max())

    # GPU = CPU: the first window's raw outputs, its boxes (after threshold
    # and NMS) and tracks
    lo, hi = windows[0]
    n_scores = sum(-(-ASD_HW[0] // s) * -(-ASD_HW[1] // s) * cfg.num_anchors for s in cfg.strides)
    out_err, near = 0.0, []
    for f in frames[lo:hi]:
        g, c = raw("cuda", f), raw("cpu", f)
        out_err = max(out_err, raw_err(g, c))
        near.append(int((np.abs(c[:n_scores] - cfg.score_threshold) <= ASD_SCORE_TOL).sum()))
    if out_err > ASD_RAW_TOL:
        raise AssertionError(f"asd window 0: raw outputs {out_err} apart (limit {ASD_RAW_TOL})")
    runs = {}
    for name, det in (("card", det_gpu), ("cpu", det_cpu)):
        dets, tracks = [], []

        def recorded(frame, det=det, dets=dets):
            dets.append(det(frame))
            return dets[-1]

        asd.talking_ratio(frames[lo:hi], recorded, asd_tubes(feats, tracks), min_track_len=1)
        runs[name] = (dets, tracks)
    reported = same_detections("asd window 0", runs["card"][0], runs["cpu"][0], near)
    (g_tr, c_tr) = runs["card"][1], runs["cpu"][1]
    if not reported and (len(g_tr) != len(c_tr) or any(
            a[0] != b[0] or not np.allclose(a[1], b[1], rtol=0, atol=1e-3)
            for a, b in zip(g_tr, c_tr))):
        raise AssertionError(f"asd window 0: the card's tracks {[t[0] for t in g_tr]} part "
                             f"from the CPU's {[t[0] for t in c_tr]}")
    n_boxes = [len(b) for b, _ in runs["card"][0]]
    log(f"  window 0, card against CPU: raw outputs (scores and box distances) max |diff| / "
        f"(1 + |CPU|) {out_err:.2e} (limit {ASD_RAW_TOL}); boxes a frame {min(n_boxes)}-"
        f"{max(n_boxes)} (sum {sum(n_boxes)}), equal on {hi - lo - reported} of {hi - lo} "
        f"frames ({reported} reported, {sum(1 for n in near if n)} frames with a CPU score "
        f"within {ASD_SCORE_TOL} of {cfg.score_threshold}); tracks {len(g_tr)} card, "
        f"{len(c_tr)} CPU, lengths {sorted(len(t[0]) for t in g_tr)[::-1][:8]}")

    # GPU = CPU: make_detector at ScrfdConfig's defaults; the seeded head's
    # biases are set as the graph's (box bias ASD_BOX_BIAS, score bias from
    # threshold_bias on the first frame), as the init's -4 finds no face
    params = scrfd.init_scrfd_params(cfg, torch.Generator().manual_seed(ASD_SEED))
    head = params["head"]
    head["score"]["bias"].zero_()
    head["bbox"]["bias"].fill_(ASD_BOX_BIAS)
    with torch.inference_mode():
        levels = scrfd.Scrfd(params, cfg).eval()(torch.as_tensor(frames[lo])[None])
    mk_bias = threshold_bias(np.concatenate([sc.numpy().ravel() for sc, _ in levels]))
    head["score"]["bias"].fill_(mk_bias)
    mods = {d: scrfd.Scrfd(params, cfg).to(d).eval() for d in ("cuda", "cpu")}
    make = {d: scrfd.make_detector(params, cfg, d) for d in ("cuda", "cpu")}
    picks = frames[lo:hi:(hi - lo) // ASD_MAKE_FRAMES][:ASD_MAKE_FRAMES]
    mk_err, mk_near, mk = 0.0, [], {"cuda": [], "cpu": []}
    for f in picks:
        with torch.inference_mode():
            o = {d: [t.cpu().numpy() for lvl in mods[d](torch.as_tensor(f).to(d)[None])
                     for t in lvl] for d in mods}
        mk_err = max(mk_err, max(raw_err(a, b) for a, b in zip(o["cuda"], o["cpu"])))
        sc = np.concatenate([x.ravel() for x in o["cpu"][0::2]])
        mk_near.append(int((np.abs(sc - cfg.score_threshold) <= ASD_SCORE_TOL).sum()))
        for d in mk:
            mk[d].append(make[d](f))
    mk_rep = same_detections("make_detector", mk["cuda"], mk["cpu"], mk_near)
    counts = {d: [len(b) for b, _ in v] for d, v in mk.items()}
    log(f"  make_detector (ScrfdConfig defaults, seeded init, score bias {mk_bias:.4f}, box "
        f"bias {ASD_BOX_BIAS}) on {len(picks)} frames: raw max |diff| / (1 + |CPU|) "
        f"{mk_err:.2e} (limit {ASD_RAW_TOL}); boxes {counts['cuda']} card, {counts['cpu']} "
        f"CPU; {mk_rep} frames reported")
    if mk_err > ASD_RAW_TOL or not any(counts["cpu"]):
        raise AssertionError(f"asd: make_detector raw outputs {mk_err} apart (limit "
                             f"{ASD_RAW_TOL}), boxes {counts}")
    del mods, make

    # Light-ASD: GPU = CPU on one planted tube
    state = lightasd.init_lightasd_params(torch.Generator().manual_seed(ASD_SEED))
    net = lightasd.make_lightasd(state)
    net_cpu = lightasd.make_lightasd(state, "cpu")
    rng = np.random.default_rng(ASD_SEED + 1)
    tubes = [(rng.integers(0, 256, (150, 112, 112)).astype(np.float32),
              feats[4 * a:4 * a + 600]) for a, _ in windows]
    faces, mfcc = tubes[0]
    t0 = time.perf_counter()
    ref = lightasd.lightasd_scores(net_cpu, faces[None], mfcc[None]).numpy()
    cpu_s = time.perf_counter() - t0
    got = lightasd.lightasd_scores(net, faces[None], mfcc[None]).cpu().numpy()
    l_err = float(np.abs(got - ref).max())
    log(f"  Light-ASD, a planted tube (faces {faces.shape}, MFCC {mfcc.shape}): logits card "
        f"against CPU max |diff| {l_err:.2e} (limit {ASD_LOGIT_TOL}; |logit| max "
        f"{np.abs(ref).max():.3f}); the CPU took {cpu_s:.2f} s")
    if not (got.shape == (1, 150) and np.isfinite(got).all() and l_err <= ASD_LOGIT_TOL):
        raise AssertionError(f"asd: Light-ASD logits {got.shape}, card against CPU {l_err}")
    del net_cpu

    # the chain over the whole video on the card; detect_faces is its two
    # parts (levels on the device, decode + NMS on the host), timed apart
    det_calls, tube_rec, asd_calls = [], [], []

    def detect(frame):
        t = time.perf_counter()
        lv = det_gpu.levels(frame)
        t1 = time.perf_counter()
        out = scrfd.decode_detections(cfg, lv, *frame.shape[:2])
        det_calls.append((t1 - t, time.perf_counter() - t1))
        return out

    def score(faces, mfcc):
        t = time.perf_counter()
        p = lightasd.track_score(net, faces, mfcc)
        asd_calls.append((time.perf_counter() - t, len(faces), p))
        return p

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    ratio = asd.talking_ratio(frames, detect, asd_tubes(feats, tube_rec, score))
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    det_s = sum(a for a, _ in det_calls)
    decode_s = sum(b for _, b in det_calls)
    asd_s = sum(t for t, _, _ in asd_calls)
    probs = [p for _, _, p in asd_calls]
    log(f"  chain over the video: wall {wall:.3f} s a 5-minute video ({len(frames) / wall:.0f} "
        f"video frames/s; {len(det_calls)} detector frames, {len(det_calls) / wall:.0f}/s); in "
        f"the device calls {det_s + asd_s:.3f} s (detector upload + forward + read-back "
        f"{det_s:.3f} s, Light-ASD {asd_s:.3f} s), host {wall - det_s - asd_s:.3f} s (decode + "
        f"NMS {decode_s:.3f} s, tubes {sum(t for _, _, t in tube_rec):.3f} s, tracking and the "
        f"rest); tracks scored {len(asd_calls)} (lengths "
        f"{sorted(n for _, n, _ in asd_calls)[::-1][:10]}), mean P(talking) "
        f"{np.mean(probs) if probs else float('nan'):.3f}; ratio {ratio:.2f}, keep "
        f"{asd.keep_clip(ratio)}; peak device memory {peak:.3f} GiB; kernel launches "
        f"{dict(build.launch_counts) or 'none'} (no hand-written kernel on this path)")
    if not (0.0 <= ratio <= 1.0 and len(det_calls) == 1500 and np.isfinite(probs).all()):
        raise AssertionError(f"asd: ratio {ratio}, {len(det_calls)} detector frames, {probs}")

    # the 10 planted tubes, one a window
    walls = []
    for faces, mfcc in tubes:
        torch.cuda.synchronize()
        t = time.perf_counter()
        p = lightasd.track_score(net, faces, mfcc)
        walls.append(time.perf_counter() - t)
        if not 0.0 <= p <= 1.0:
            raise AssertionError(f"asd: planted tube probability {p}")
    fx = torch.as_tensor(tubes[0][0][None]).to(dev)
    mx = torch.as_tensor(tubes[0][1][None]).to(dev)
    asd_ms = kernel_timing.cuda_ms(lambda: lightasd.lightasd_scores(net, fx, mx))
    _, p_wall, busy, groups = profiled(lambda: lightasd.lightasd_scores(net, fx, mx))
    log(f"  Light-ASD, {len(tubes)} planted tubes of 150 frames through track_score: "
        f"{np.median(walls) * 1e3:.2f} ms a tube (median; {min(walls) * 1e3:.2f}-"
        f"{max(walls) * 1e3:.2f}), forward {asd_ms:.3f} ms by CUDA events, device busy "
        f"{busy * 1e3:.3f} ms (~60 GFLOP: {60e9 / busy / 1e12:.1f} TFLOP/s fp32)")
    log_profile("Light-ASD tube", p_wall, busy, groups)

    # the detector alone: one call, CUDA events, device time
    x = ((torch.as_tensor(frames[lo]).to(dev).to(torch.float32) - 127.5) / 128.0) \
        .permute(2, 0, 1)[None]
    fwd_ms = kernel_timing.cuda_ms(lambda: fwd["cuda"](x), iters=50)
    n_prof = 50
    _, d_wall, d_busy, d_groups = profiled(lambda: [det_gpu(f) for f in frames[lo:lo + n_prof]])
    per_frame = [a + b for a, b in det_calls]
    log(f"  detector: detect_faces {np.median(per_frame) * 1e3:.3f} ms a frame (median of the "
        f"chain's {len(per_frame)}; {np.percentile(per_frame, 99) * 1e3:.3f} p99), forward "
        f"{fwd_ms:.3f} ms by CUDA events, device busy {d_busy / n_prof * 1e3:.3f} ms a frame "
        f"over {n_prof} calls, {len(model.nodes)} graph nodes")
    log_profile(f"detector, {n_prof} frames", d_wall, d_busy, d_groups)

    # one window of the chain, profiled
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        asd.talking_ratio(frames[lo:hi], det_gpu, asd_tubes(feats, None, score))
        torch.cuda.synchronize()
        w_wall = time.perf_counter() - t0
    log("  window 0 of the chain profiled:")
    profile_stream.report(prof, w_wall)


def phase_midsize() -> dict:
    """The port's forward at Qwen2-VL-7B's width (4 LLM layers, 4 ViT
    blocks, ``tools/midsize.py``) against HF's golden
    ``tests/goldens/hf_midsize.npz``: text, multimodal (and its M-RoPE
    positions), the streaming continuation and the vision tower, through
    K4's forward, K3 (both forms) and K1. fp32 within JAX's limits
    (``midsize.FP32``); then the same model rounded to bf16 within
    ``midsize.BF16``. Returns the two runs' launch counts."""
    import torch

    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import midsize

    t0 = time.perf_counter()
    golden, cfg, model = midsize.load("cuda", torch.float32)
    torch.cuda.synchronize()
    log(f"  7B width, depth 4 / 4: {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
        f"params from the recipe, fp32 on the card in {time.perf_counter() - t0:.1f} s")
    counts = {}
    for dtype, limits in ((torch.float32, midsize.FP32), (torch.bfloat16, midsize.BF16)):
        model.to(dtype)      # rounds to nearest even, as convert_state_dict's copy_ does
        build.reset_launch_counts()
        out = midsize.run_cases(model, cfg, golden)
        torch.cuda.synchronize()
        for k, n in build.launch_counts.items():
            counts[k] = counts.get(k, 0) + n
        missing = [k for k in MIDSIZE_KERNELS if build.launch_counts.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"midsize {dtype}: {missing} not launched")
        try:
            report = midsize.check(golden, out, limits)
        finally:
            for case in ("text", "mm", "cont", "v_out"):
                ref = golden[f"{case}_tail"] if case != "v_out" else golden["v_out"]
                got = out[case][-4:] if case != "v_out" else out[case]
                log(f"  {str(dtype)[6:]:8s} {case:5s}: max_abs_err "
                    f"{abs(got - ref).max():.3e} (|ref| max {abs(ref).max():.3f})")
        for case, r in report.items():
            log(f"  {str(dtype)[6:]:8s} {case:5s}: {r['worst']:.3f} of the limit"
                + (f"; argmax agrees on {r['argmax_agree']:.3f} of the {r['decided']:.3f} "
                   f"decided (margin > {limits.argmax_eps})" if "decided" in r else ""))
    log(f"  launches of the two runs: {counts}")
    del model
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
    run_phase("kernels_tp", lambda: phase_kernels_tp(results))
    run_phase("tiny", phase_tiny)
    run_phase("tiny_pool", phase_tiny_pool)
    run_phase("tiny_w8", phase_tiny_w8)
    run_phase("tiny_asr", phase_tiny_asr)
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
               "bf16_gib": session.model_bytes(model) / 2**30, "parts": w8_parts(model_w8)}
    main_w8_counts, main_w8_spec_counts = run_phase(
        "main_w8", lambda: phase_main_w8(cfg, model_w8, main_record, main_sum, w8_init))
    pool_w8_counts, pool_w8_record, pool_w8_sum = run_phase(
        "pool_w8", lambda: phase_pool_w8(cfg, model_w8, pool_sum))
    tp_counts, rank_bytes = run_phase("tp_serve", lambda: phase_tp_serve(
        cfg, (model, model_w8), main_record, main_sum, pool_w8_record, pool_w8_sum))
    del main_record, model_w8, pool_w8_record
    gc.collect()
    torch.cuda.empty_cache()
    memory_counts = run_phase("memory_plan", lambda: phase_memory_plan(
        cfg, model, main_sum, pool_sum, w8_init["parts"], rank_bytes, card))
    gc.collect()
    torch.cuda.empty_cache()
    eval_counts, cc_counts, _ = run_phase("eval", lambda: phase_eval(cfg, model))
    gc.collect()
    torch.cuda.empty_cache()
    asr_words = run_phase("asr", phase_asr)
    gc.collect()
    torch.cuda.empty_cache()
    lmm_counts, loss_counts, produce = run_phase(
        "produce", lambda: phase_produce(cfg, model, asr_words))
    gc.collect()
    torch.cuda.empty_cache()
    run_phase("asd", phase_asd)
    gc.collect()
    torch.cuda.empty_cache()
    models = [model]
    del model                                # checkpoint_live frees the serving 7B
    checkpoint_counts, checkpoint_w8_counts, app_counts = run_phase(
        "checkpoint_live", lambda: phase_checkpoint_live(cfg, models, card))
    gc.collect()
    torch.cuda.empty_cache()
    run_phase("tiny_train", phase_tiny_train)
    train_counts = run_phase("train", phase_train)
    gc.collect()
    torch.cuda.empty_cache()
    train_cli_counts, cli_run = run_phase("train_cli", phase_train_cli)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        mesh_counts, mesh_records = run_phase("mesh", lambda: phase_mesh(cli_run))
        sp_pp_counts = run_phase("sp_pp", lambda: phase_sp_pp(cli_run, mesh_records))
    finally:
        shutil.rmtree(cli_run["work"], ignore_errors=True)
    del cli_run
    gc.collect()
    torch.cuda.empty_cache()
    midsize_counts = run_phase("midsize", phase_midsize)
    kernels = [{
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": sum(c.get(name, 0) for c in (main_counts, pool_counts, spec_counts,
                                                 adversarial_counts, pool_spec_counts,
                                                 main_w8_counts, main_w8_spec_counts,
                                                 pool_w8_counts, tp_counts, memory_counts,
                                                 eval_counts,
                                                 cc_counts,
                                                 checkpoint_counts, checkpoint_w8_counts,
                                                 *app_counts, train_counts, train_cli_counts,
                                                 mesh_counts, *sp_pp_counts.values(),
                                                 lmm_counts, loss_counts,
                                                 midsize_counts)),
        "max_abs_err": results[name]["max_abs_err"],
        "ms": results[name]["ms"],
        "plain_ms": results[name]["plain_ms"],
        "bound_ms": results[name]["bound_ms"],
        "bound_by": results[name]["bound_by"],
        "library_ms": results[name]["library_ms"],
        **({"noncausal": results[name]["noncausal"]} if "noncausal" in results[name] else {}),
        **({"tp": results[name]["tp"]} if "tp" in results[name] else {}),
        **({"produce": produce[name]} if name in produce else {}),
    } for name, (src, replaces) in KERNELS.items()]
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--pp-worker"]:
        sys.exit(pp_worker(sys.argv[2]))
    sys.exit(main())

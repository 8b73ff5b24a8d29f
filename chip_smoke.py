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
                 variants, K3 vit_group_attention) against its plain PyTorch
                 version on the card at the paths' shapes: bf16 inputs
                 against the plain version in fp32 on the same inputs (max
                 abs <= 2e-2), and an fp32 case (<= 1e-4); median times of
                 both (CUDA events). The int8 kernels run on the pool's cache
                 [28, 8, 4, 8192, 128] int8 with bf16 scales.
  4. tiny      — tiny config, fp32, seeded random weights: the engine on the
                 CPU (plain versions) and on the GPU (kernels) give identical
                 greedy text over 3 chunks.
  5. tiny_pool — the same model in a StreamServer with an int8 cache,
                 capacity 3 and 2 streams over 4 ticks, on the CPU and on the
                 GPU: identical text for every stream.
  6. main      — the single-stream session of ``livecc_tpu_torch/tools/
                 session.py``: Qwen2-VL-7B at full width and depth, bf16,
                 random weights drawn on the card from a seeded generator;
                 live_cc_once_for_evaluation over 14 frames of 308x560 (a
                 6-frame chunk and four 2-frame chunks), 16 new tokens per
                 chunk, greedy, repetition penalty 1.05.
  7. pool      — the same 7B model object in the serving pool of session.py:
                 StreamServer with 8 slots, an int8 KV cache of 8192, 8
                 streams of 308x560 frames (a 6-frame init chunk, then 3
                 steady ticks of 2-frame chunks). Every stream must get text
                 for all 4 chunks.

Launch counts are reset just before each of main and pool and read just
after; every kernel of that path must have launched. Every phase always
runs. After all of them passed it prints one JSON line ``{"kernels": [...]}``
and, as its last line, ``{"ok": true, "device": {...}}``. It imports nothing
of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
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
}
# the kernels each path must launch
MAIN_KERNELS = ("vit_group_attention", "flash_prefill", "flash_decode")
POOL_KERNELS = ("vit_group_attention", "flash_prefill_int8", "flash_decode_int8")
BF16_TOL = 2e-2     # the JAX package's own bf16 bound (tests/test_vit_attention.py:22)
FP32_TOL = 1e-4


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
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``iters`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels() -> dict:
    """Kernel vs plain version on the card; returns per-kernel results."""
    import torch

    from livecc_tpu_torch.ops.flash_attention import (
        flash_decode, flash_decode_plain, flash_prefill, flash_prefill_plain)
    from livecc_tpu_torch.ops.vit_attention import vit_group_attention, vit_group_attention_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    results: dict[str, dict] = {}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=f32).to(dtype)

    def check(name, label, out, ref, tol, timed=None):
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
        if timed is not None:
            kernel_fn, plain_fn = timed
            r["ms"] = cuda_ms(kernel_fn)
            r["plain_ms"] = cuda_ms(plain_fn)
            log(f"  {name:20s} {label:48s} kernel {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms")

    # K3: the ViT at the 720p serving budget (g = 880 = 22 x 40) and g = 308
    for ng, g, dtype, tol, timed in ((3, 880, bf16, BF16_TOL, True), (3, 308, bf16, BF16_TOL, False),
                                     (1, 308, f32, FP32_TOL, False)):
        q, k, v = (randn((ng, g, 16, 80), dtype) for _ in range(3))
        qf, kf, vf = q.float(), k.float(), v.float()
        out = vit_group_attention(q, k, v)
        ref = vit_group_attention_plain(qf, kf, vf)
        check("vit_group_attention", f"NG={ng} g={g} H=16 D=80 {str(dtype)[6:]}", out, ref, tol,
              (lambda: vit_group_attention(q, k, v),
               lambda: vit_group_attention_plain(q, k, v)) if timed else None)
        del q, k, v, qf, kf, vf, out, ref

    # K1 / K2: the 7B's cache [L=28, B, Hk=4, Smax=8192, D=128], layer 27
    L, hq, hk, d, smax, li = 28, 28, 4, 128, 8192, 27
    for b in (1, 2):
        k5, v5 = (randn((L, b, hk, smax, d), bf16) for _ in range(2))
        kl, vl = k5[li].float(), v5[li].float()
        if b == 1:
            prefill_cases = [(1024, [0], [690], True), (256, [1500], [1756], False)]
        else:
            prefill_cases = [(256, [0, 1500], [200, 1756], False)]
        for sq, off, lim, timed in prefill_cases:
            q = randn((b, hq, sq, d), bf16)
            off_t = torch.tensor(off, dtype=torch.int32, device=dev)
            lim_t = torch.tensor(lim, dtype=torch.int32, device=dev)
            out = flash_prefill(q, k5, v5, off_t, lim_t, layer_index=li)
            ref = flash_prefill_plain(q.float(), kl, vl, off_t, lim_t)
            check("flash_prefill", f"B={b} Sq={sq} offset={off} kv_limit={lim} bf16", out, ref,
                  BF16_TOL,
                  (lambda: flash_prefill(q, k5, v5, off_t, lim_t, layer_index=li),
                   lambda: flash_prefill_plain(q, k5[li], v5[li], off_t, lim_t)) if timed else None)
        limits = [[1], [777], [8192]] if b == 1 else [[1, 8192], [777, 3]]
        for lim in limits:
            q = randn((b, hq, 1, d), bf16)
            lim_t = torch.tensor(lim, dtype=torch.int32, device=dev)
            out = flash_decode(q, k5, v5, lim_t, layer_index=li)
            ref = flash_decode_plain(q.float(), kl, vl, lim_t)
            timed = b == 1 and lim == [777]
            check("flash_decode", f"B={b} kv_limit={lim} bf16", out, ref, BF16_TOL,
                  (lambda: flash_decode(q, k5, v5, lim_t, layer_index=li),
                   lambda: flash_decode_plain(q, k5[li], v5[li], lim_t)) if timed else None)
        del k5, v5, kl, vl
    # fp32 cases (the tiny end-to-end run's dtype), strided q as the text tower passes it
    k4, v4 = (randn((2, 2, 512, 16), f32) for _ in range(2))
    qs = randn((2, 100, 4, 16), f32).transpose(1, 2)
    off_t = torch.tensor([37, 300], dtype=torch.int32, device=dev)
    lim_t = torch.tensor([137, 400], dtype=torch.int32, device=dev)
    check("flash_prefill", "B=2 Sq=100 D=16 strided q fp32", flash_prefill(qs, k4, v4, off_t, lim_t),
          flash_prefill_plain(qs, k4, v4, off_t, lim_t), FP32_TOL)
    q1 = randn((2, 4, 1, 16), f32)
    check("flash_decode", "B=2 D=16 fp32", flash_decode(q1, k4, v4, lim_t),
          flash_decode_plain(q1, k4, v4, lim_t), FP32_TOL)
    del k4, v4, qs, q1

    # K1-int8 / K2-int8 on the pool's cache: [28, 8, 4, 8192, 128] int8 with
    # lane-major bf16 scales [28, 8, 4, 1, 8192], layer 27
    from livecc_tpu_torch.models.qwen2_vl.text import quantize_kv

    def int8_cache(shape):
        codes, scale = quantize_kv(randn(shape, bf16))
        return codes, scale.transpose(-1, -2).contiguous()

    b = 8
    (k8, ks8), (v8, vs8) = (int8_cache((L, b, hk, smax, d)) for _ in range(2))
    layer = (k8[li], v8[li], ks8[li], vs8[li])
    off_t = torch.tensor([0, 300, 1500, 7, 64, 900, 4000, 7936], dtype=torch.int32, device=dev)
    lim_t = off_t + 256
    q = randn((b, 256, hq, d), bf16).transpose(1, 2)           # strided, as the model passes it
    check("flash_prefill_int8", f"B=8 Sq=256 offset={off_t.tolist()} bf16",
          flash_prefill(q, k8, v8, off_t, lim_t, layer_index=li, k_scale=ks8, v_scale=vs8),
          flash_prefill_plain(q.float(), *layer[:2], off_t, lim_t, *layer[2:]), BF16_TOL,
          (lambda: flash_prefill(q, k8, v8, off_t, lim_t, layer_index=li, k_scale=ks8,
                                 v_scale=vs8),
           lambda: flash_prefill_plain(q, *layer[:2], off_t, lim_t, *layer[2:])))
    lim_d = torch.tensor([1, 777, 8192, 4000, 1, 777, 8192, 2500], dtype=torch.int32, device=dev)
    q = randn((b, 1, hq, d), bf16).transpose(1, 2)
    check("flash_decode_int8", f"B=8 kv_limit={lim_d.tolist()} bf16",
          flash_decode(q, k8, v8, lim_d, layer_index=li, k_scale=ks8, v_scale=vs8),
          flash_decode_plain(q.float(), *layer[:2], lim_d, *layer[2:]), BF16_TOL,
          (lambda: flash_decode(q, k8, v8, lim_d, layer_index=li, k_scale=ks8, v_scale=vs8),
           lambda: flash_decode_plain(q, *layer[:2], lim_d, *layer[2:])))
    del k8, v8, ks8, vs8, layer
    # bf16 K2 at the pool's B = 8 and the same limits, beside K2-int8
    k5, v5 = (randn((L, b, hk, smax, d), bf16) for _ in range(2))
    check("flash_decode", f"B=8 kv_limit={lim_d.tolist()} bf16",
          flash_decode(q, k5, v5, lim_d, layer_index=li),
          flash_decode_plain(q.float(), k5[li].float(), v5[li].float(), lim_d), BF16_TOL)
    b8 = (cuda_ms(lambda: flash_decode(q, k5, v5, lim_d, layer_index=li)),
          cuda_ms(lambda: flash_decode_plain(q, k5[li], v5[li], lim_d)))
    log(f"  {'flash_decode':20s} {'B=8 (pool shape) bf16 cache':48s} kernel {b8[0]:.3f} ms  "
        f"plain {b8[1]:.3f} ms")
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
    check("flash_decode_int8", "B=2 D=16 fp32", flash_decode(q1, k4, v4, lim_t, k_scale=ks4,
                                                              v_scale=vs4),
          flash_decode_plain(q1, k4, v4, lim_t, ks4, vs4), FP32_TOL)
    torch.cuda.empty_cache()
    return results


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


def phase_main(cfg, model) -> dict:
    import torch

    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import session

    eng = session.new_engine(cfg, model)
    frames = session.main_frames()
    state = eng.new_stream()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    out = session.run_session(eng, frames, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for (t_a, t_b, text), rec in zip(out, eng.chunk_log):
        log(f"  chunk {t_a:4.1f}-{t_b:4.1f}s  wall {rec.seconds * 1e3:9.2f} ms  prompt "
            f"{rec.prompt_tokens:4d} tok  generated {rec.generated_tokens:2d} tok  {text!r}")
    log(f"  main path: {len(out)} chunks in {wall:.2f} s, peak memory {peak:.2f} GiB, "
        f"launches {counts}")
    if len(out) != 5 or len(eng.chunk_log) != 5:
        raise AssertionError(f"expected 5 chunks, got {len(out)}")
    if not all(rec.generated_tokens > 0 for rec in eng.chunk_log):
        raise AssertionError("a chunk generated no token")
    if state.logits is None or state.logits.shape != (1, cfg.text.vocab_size) or not bool(
            torch.isfinite(state.logits).all()):
        raise AssertionError("last prefill logits missing, misshapen or non-finite")
    missing = [name for name in MAIN_KERNELS if counts.get(name, 0) <= 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")
    return counts


def phase_pool(cfg, model) -> dict:
    """The 7B in the serving pool: 8 streams, int8 KV, 4 ticks."""
    import torch

    from livecc_tpu_torch.ops import build
    from livecc_tpu_torch.tools import session

    server = session.pool_server(cfg, model)
    t0 = time.perf_counter()
    server.warmup([(session.HEIGHT, session.WIDTH)])
    log(f"  warmup (init path + one pool step on the scratch pool): "
        f"{time.perf_counter() - t0:.2f} s")
    server.engine.metrics.reset()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    out, walls = session.run_pool(server)
    torch.cuda.synchronize()
    counts = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    pool = server.pool_caches
    kv_gb = (pool.k.nbytes + pool.v.nbytes) / 1e9
    scale_mb = (pool.k_scale.nbytes + pool.v_scale.nbytes) / 1e6
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
        raise AssertionError(f"pool: expected {1 + session.POOL_STEADY_TICKS} chunks of text "
                             f"for each of {session.POOL_STREAMS} streams")
    if not bool((pool.offset > 0).all()) or not bool(
            torch.isfinite(pool.k_scale.float()).all() and torch.isfinite(pool.v_scale.float()).all()):
        raise AssertionError("pool: a slot never advanced, or non-finite scales")
    missing = [name for name in POOL_KERNELS if counts.get(name, 0) <= 0]
    if missing:
        raise AssertionError(f"the pool path never launched {missing}")
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
    t0 = time.perf_counter()
    cfg, model = session.main_model()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"7B init: {n_params / 1e9:.3f} B params bf16 in {time.perf_counter() - t0:.1f} s")
    main_counts = run_phase("main", lambda: phase_main(cfg, model))
    pool_counts = run_phase("pool", lambda: phase_pool(cfg, model))
    kernels = [{
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": main_counts.get(name, 0) + pool_counts.get(name, 0),
        "max_abs_err": results[name]["max_abs_err"],
        "ms": results[name]["ms"],
        "plain_ms": results[name]["plain_ms"],
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

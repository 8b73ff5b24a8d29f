"""Time the port's kernels on the card, two ways.

  * ``cuda_ms(fn)``: the median over 10 calls, each between two CUDA events
    after a synchronize. The call's host work (checks, allocations, the
    ctypes launch) runs after the start event has passed on an idle card,
    so a kernel whose device time is shorter than that host work reads as
    the host work: this is what one call costs a caller who waits for it.
    ``chip_smoke.py``'s ``ms``, ``plain_ms`` and ``library_ms`` use it.
  * ``graph_ms(fn)``: device time. 10 calls captured in one CUDA graph
    (their allocations come from the graph's pool), replayed 5 times
    between two events; no host work runs between the calls.
  * ``replay_ms(graph)``: device time of one replay of a graph already
    captured (the decode loops' steps, ``engine/graphs.py``): replays
    enqueued back to back between two events; a graph launch enqueues in
    microseconds, so the card runs them without a gap.

Run as a script, by path, with the checkout to time first on
``PYTHONPATH``, it times that checkout's ``flash_decode`` (K2 and K2-int8),
``vit_group_attention`` (K3), ``flash_prefill`` (K1 and, with scales,
K1-int8), ``train_attention_fwd`` / ``train_attention_bwd`` (K4, causal and,
where the checkout has it, non-causal; and the forward and the backward
at the other shapes of their paths, ``TRAIN_FWD_SHAPES`` and
``TRAIN_BWD_SHAPES``) and ``w8a16_gemm`` (K5) both ways at
``chip_smoke.py``'s timed shapes and prints one JSON line, so two versions
of the kernels compare on one card in one call:

    PYTHONPATH=. python3 livecc_tpu_torch/tools/kernel_timing.py
    PYTHONPATH=<another checkout> python3 livecc_tpu_torch/tools/kernel_timing.py

Each case's line carries ``sha256``, a digest of its outputs' bytes
(``digest``): the inputs are drawn from seeded generators on the card, so
two checkouts whose kernels give the same bits print the same digests.

Arguments, if any, name the kinds to time (``decode``, ``decode_tp``: K2
and K2-int8 at a TP rank's heads, ``vit``,
``vit_paths``: K3 at the eval, train_cli and produce paths' shapes,
``prefill``, ``prefill_tp``: K1 at a TP rank's heads, ``prefill_int8``,
``train``, ``w8``: K5 at ``W8_SHAPES``, ``w8_large``: K5 at its large
form's shapes, ``W8_LARGE_SHAPES``); by default all but ``w8_large``, which
``w8`` covers.

It uses only the six wrappers' public signatures,
``models.qwen2_vl.text.quantize_kv`` and ``ops.quant.quantize_weight``.
Needs a CUDA GPU.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys

import torch


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of one call of ``fn`` over ``iters`` calls, each
    between two CUDA events after a synchronize (host work included)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def replay_ms(graph: torch.cuda.CUDAGraph, replays: int = 20, warmup: int = 2) -> float:
    """Device milliseconds per replay of a captured ``graph``, ``replays``
    replays back to back between two CUDA events."""
    for _ in range(warmup):
        graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


def graph_ms(fn, iters: int = 10, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``iters`` calls captured in one
    CUDA graph (after a warm-up call on a side stream, as capture asks),
    replayed ``replays`` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


# chip_smoke.py's timed decode shapes: the 7B's cache [L, B, Hk, Smax, D], layer 27
L, HQ, HK, D, SMAX, LAYER = 28, 28, 4, 128, 8192, 27
POOL_LIMITS = [1, 777, 8192, 4000, 1, 777, 8192, 2500]


def decode_cases():
    """(label, call) of K2 at B = 1, kv 777; K2 at B = 8 and K2-int8 at B = 8
    at the pool's limits."""
    from livecc_tpu_torch.models.qwen2_vl.text import quantize_kv
    from livecc_tpu_torch.ops.flash_attention import flash_decode

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    k, v = (randn((L, 1, HK, SMAX, D)) for _ in range(2))
    q = randn((1, HQ, 1, D))
    lim = torch.tensor([777], dtype=torch.int32, device=dev)
    yield "K2 B=1 kv_limit=[777] bf16", lambda: flash_decode(q, k, v, lim, layer_index=LAYER)
    b = len(POOL_LIMITS)
    lim = torch.tensor(POOL_LIMITS, dtype=torch.int32, device=dev)
    q = randn((b, 1, HQ, D)).transpose(1, 2)
    k, v = (randn((L, b, HK, SMAX, D)) for _ in range(2))
    yield f"K2 B=8 kv_limit={POOL_LIMITS} bf16", lambda: flash_decode(q, k, v, lim,
                                                                       layer_index=LAYER)
    (k, ks), (v, vs) = (quantize_kv(randn((L, b, HK, SMAX, D))) for _ in range(2))
    ks, vs = (s.transpose(-1, -2).contiguous() for s in (ks, vs))
    yield f"K2-int8 B=8 kv_limit={POOL_LIMITS} int8 cache", lambda: flash_decode(
        q, k, v, lim, layer_index=LAYER, k_scale=ks, v_scale=vs)


def decode_tp_cases():
    """(label, call) of K2 at B = 1 (kv 777) and B = 8, and K2-int8 at B = 8
    (``POOL_LIMITS``), at each of ``PREFILL_TP_HEADS``: one tensor-parallel
    rank's heads of the 7B (chip_smoke's kernels_tp)."""
    from livecc_tpu_torch.models.qwen2_vl.text import quantize_kv
    from livecc_tpu_torch.ops.flash_attention import flash_decode

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    for hq, hk in PREFILL_TP_HEADS:
        for lims in ([777], POOL_LIMITS):
            b = len(lims)
            k, v = (randn((L, b, hk, SMAX, D)) for _ in range(2))
            q = randn((b, 1, hq, D)).transpose(1, 2)
            lim = torch.tensor(lims, dtype=torch.int32, device=dev)
            yield (f"K2 TP rank Hq={hq} Hk={hk} B={b} kv_limit={lims} bf16",
                   lambda q=q, k=k, v=v, lim=lim: flash_decode(q, k, v, lim, layer_index=LAYER))
            del k, v
        (k, ks), (v, vs) = (quantize_kv(randn((L, 8, hk, SMAX, D))) for _ in range(2))
        ks, vs = (s.transpose(-1, -2).contiguous() for s in (ks, vs))
        yield (f"K2-int8 TP rank Hq={hq} Hk={hk} B=8 kv_limit={POOL_LIMITS} int8 cache",
               lambda q=q, k=k, v=v, ks=ks, vs=vs, lim=lim: flash_decode(
                   q, k, v, lim, layer_index=LAYER, k_scale=ks, v_scale=vs))
        del k, v, ks, vs


# chip_smoke.py's timed K3 shapes (NG, g) at the 7B ViT's H = 16, D = 80: the
# first chunk and a steady chunk at 308x560 (22 x 40 patches), the pool's
# steady tick (8 streams' 2-frame chunks in one call), and the call of
# chip_smoke's train phase (2 packed 24-frame clips of 16 x 34 patches per
# micro-batch: 24 groups plus 7 of pad, a bucket of 16384 patches rounded up
# to whole groups; chip_smoke checks that its train phase makes this call,
# the last shape)
VIT_SHAPES = ((3, 880), (1, 880), (8, 880), (31, 544))
VIT_HEADS, VIT_DIM = 16, 80
# and its timed K1 shapes (Sq, offset, kv_limit) at B = 1 on layer 27 of the
# 7B's bf16 cache: the 6-frame first chunk's bucket, a steady 2-frame chunk
# and a verify window of speculative decoding (k_draft + 1 = 9 queries)
WINDOW_SQ = 9
PREFILL_SHAPES = ((1024, 0, 690), (256, 1500, 1756), (WINDOW_SQ, 1500, 1500 + WINDOW_SQ))


def vit_cases():
    """(label, call) of K3 at each of ``VIT_SHAPES``, bf16."""
    from livecc_tpu_torch.ops.vit_attention import vit_group_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for ng, g in VIT_SHAPES:
        q, k, v = (torch.randn((ng, g, VIT_HEADS, VIT_DIM), generator=gen, device=dev).bfloat16()
                   for _ in range(3))
        yield (f"K3 NG={ng} g={g} H={VIT_HEADS} D={VIT_DIM} bf16",
               lambda q=q, k=k, v=v: vit_group_attention(q, k, v))


# K3 at the other paths' shapes (NG, g, where): the 720p MCQ item (eval),
# train_cli's 60 s and 120 s samples, lmm4asd's batch (produce)
VIT_PATH_SHAPES = ((32, 2880, "MCQ item"), (60, 1196, "train_cli 60 s"),
                   (120, 760, "train_cli 120 s"), (512, 264, "produce batch"))
# K1 at a tensor-parallel rank's heads of the 7B (Hq, Hk: M = 2, 4), a
# steady chunk and a verify window at offset 1500 (chip_smoke's kernels_tp)
PREFILL_TP_HEADS = ((14, 2), (7, 1))


def vit_path_cases():
    """(label, call) of K3 at each of ``VIT_PATH_SHAPES``, bf16."""
    from livecc_tpu_torch.ops.vit_attention import vit_group_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for ng, g, where in VIT_PATH_SHAPES:
        q, k, v = (torch.randn((ng, g, VIT_HEADS, VIT_DIM), generator=gen, device=dev).bfloat16()
                   for _ in range(3))
        yield (f"K3 {where} NG={ng} g={g} H={VIT_HEADS} D={VIT_DIM} bf16",
               lambda q=q, k=k, v=v: vit_group_attention(q, k, v))
        del q, k, v


def prefill_tp_cases():
    """(label, call) of K1 at ``PREFILL_TP_HEADS``: Sq = 256 and 9 at offset
    1500, kv_limit offset + Sq, B = 1, bf16, q strided."""
    from livecc_tpu_torch.ops.flash_attention import flash_prefill

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for hq, hk in PREFILL_TP_HEADS:
        k, v = (torch.randn((L, 1, hk, SMAX, D), generator=gen, device=dev).bfloat16()
                for _ in range(2))
        for sq in (256, WINDOW_SQ):
            q = torch.randn((1, sq, hq, D), generator=gen, device=dev).bfloat16().transpose(1, 2)
            off_t, lim_t = (torch.tensor([x], dtype=torch.int32, device=dev)
                            for x in (1500, 1500 + sq))
            yield (f"K1 TP rank Hq={hq} Hk={hk} Sq={sq} offset=1500 bf16",
                   lambda q=q, o=off_t, lm=lim_t, k=k, v=v: flash_prefill(q, k, v, o, lm,
                                                                          layer_index=LAYER))
        del k, v


def prefill_cases():
    """(label, call) of K1 at each of ``PREFILL_SHAPES``, bf16, q strided as
    the text tower passes it."""
    from livecc_tpu_torch.ops.flash_attention import flash_prefill

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k, v = (torch.randn((L, 1, HK, SMAX, D), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    for sq, off, lim in PREFILL_SHAPES:
        q = torch.randn((1, sq, HQ, D), generator=gen, device=dev).bfloat16().transpose(1, 2)
        off_t, lim_t = (torch.tensor([x], dtype=torch.int32, device=dev) for x in (off, lim))
        yield (f"K1 B=1 Sq={sq} offset={off} kv_limit={lim} bf16",
               lambda q=q, o=off_t, lm=lim_t: flash_prefill(q, k, v, o, lm, layer_index=LAYER))


# K1-int8's shapes on the pool's int8 cache [L, 8, Hk, Smax, D], layer 27, bf16
# q strided: chip_smoke's timed tick (rows 0-7936 deep) and a steady tick
# (every row ~1300 deep), 256-query chunks at kv_limit = offset + 256; the
# solo init chunk (B = 1, Sq = 1024, offset 0, kv_limit 690); and a verify
# window at the steady tick's depths (Sq = WINDOW_SQ, kv_limit = offset + 9)
INT8_SQ = 256
INT8_POOL_OFFSETS = (0, 300, 1500, 7, 64, 900, 4000, 7936)
INT8_STEADY_OFFSETS = (1300, 1310, 1290, 1320, 1305, 1295, 1315, 1300)
INT8_SOLO = (1024, 0, 690)


def prefill_int8_cases():
    """(label, call) of K1-int8 at the timed pool tick, a steady tick and
    the solo init chunk, bf16 q."""
    from livecc_tpu_torch.models.qwen2_vl.text import quantize_kv
    from livecc_tpu_torch.ops.flash_attention import flash_prefill

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def cache(b):
        codes, scale = quantize_kv(torch.randn((L, b, HK, SMAX, D), generator=gen,
                                               device=dev).bfloat16())
        return codes, scale.transpose(-1, -2).contiguous()

    def call(q, k, v, off, lim):
        o, lm = (torch.tensor(x, dtype=torch.int32, device=dev) for x in (off, lim))
        return lambda: flash_prefill(q, k[0], v[0], o, lm, layer_index=LAYER, k_scale=k[1],
                                     v_scale=v[1])

    b = len(INT8_POOL_OFFSETS)
    k, v = cache(b), cache(b)
    q = torch.randn((b, INT8_SQ, HQ, D), generator=gen, device=dev).bfloat16().transpose(1, 2)
    for name, offs in (("pool tick", INT8_POOL_OFFSETS), ("steady tick", INT8_STEADY_OFFSETS)):
        yield (f"K1-int8 {name} B={b} Sq={INT8_SQ} offsets={list(offs)} bf16",
               call(q, k, v, offs, [o + INT8_SQ for o in offs]))
    del k, v
    sq, off, lim = INT8_SOLO
    k, v = cache(1), cache(1)
    q = torch.randn((1, sq, HQ, D), generator=gen, device=dev).bfloat16().transpose(1, 2)
    yield (f"K1-int8 solo init chunk B=1 Sq={sq} offset={off} kv_limit={lim} bf16",
           call(q, k, v, [off], [lim]))
    del k, v
    k, v = cache(b), cache(b)
    q = torch.randn((b, WINDOW_SQ, HQ, D), generator=gen, device=dev).bfloat16().transpose(1, 2)
    yield (f"K1-int8 verify window B={b} Sq={WINDOW_SQ} offsets={list(INT8_STEADY_OFFSETS)} bf16",
           call(q, k, v, INT8_STEADY_OFFSETS, [o + WINDOW_SQ for o in INT8_STEADY_OFFSETS]))


# and its timed K4 shape: one packed training row of the 7B's heads
# (chip_smoke.py's K4_CASES[-1]), segments of TRAIN_LENGTHS then pad
TRAIN_S, TRAIN_LENGTHS = 8192, (2900, 2700, 2300)
TRAIN_HEADS = (28, 4, 128)
# K4's forward at the other shapes of its paths, bf16: (label, B, S, Hq, Hk,
# segment lengths of each row, then pad as segment 0): one causal segment of
# 8192 and of 32768 (chip_smoke's yardstick), train_cli's 120 s row, the
# MCQ item's last layer, lmm4asd's batch, lm_loss's longest sample, and the
# packed row at one tensor-parallel rank's heads (M = 2, 4)
TRAIN_FWD_SHAPES = (
    ("one segment", 1, 8192, 28, 4, (8192,)),
    ("one segment", 1, 32768, 28, 4, (32768,)),
    ("train_cli's 120 s row", 1, 32768, 28, 4, (29422,)),
    ("the MCQ item", 1, 32768, 28, 4, (23284,)),
    ("lmm4asd's batch", 64, 1024, 28, 4, (731,)),
    ("lm_loss's longest sample", 1, 2048, 28, 4, (1985,)),
    ("TP rank M=2", 1, TRAIN_S, 14, 2, TRAIN_LENGTHS),
    ("TP rank M=4", 1, TRAIN_S, 7, 1, TRAIN_LENGTHS),
)
# and its backward, bf16, on the forward's o and lse: train_cli's 120 s row,
# one causal segment of 8192 and of 32768, and the packed row at one
# tensor-parallel rank's heads (M = 2, 4)
TRAIN_BWD_SHAPES = (
    ("train_cli's 120 s row", 1, 32768, 28, 4, (29422,)),
    ("one segment", 1, 8192, 28, 4, (8192,)),
    ("one segment", 1, 32768, 28, 4, (32768,)),
    ("TP rank M=2", 1, TRAIN_S, 14, 2, TRAIN_LENGTHS),
    ("TP rank M=4", 1, TRAIN_S, 7, 1, TRAIN_LENGTHS),
)


def train_operands(b: int, s: int, hq: int, hk: int, lengths, gen: torch.Generator):
    """(qs, k, v, do, seg) of K4 in bf16: x ~ N(0, 1), q pre-scaled; every
    row's segments 1.. of ``lengths``, then pad as segment 0."""
    from livecc_tpu_torch.ops.attention import prescaled

    d = TRAIN_HEADS[2]
    dev = gen.device
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
                   for h in (hq, hk, hk, hq))
    seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
    at = 0
    for i, n in enumerate(lengths):
        seg[:, at:at + n] = i + 1
        at += n
    return prescaled(q), k, v, do, seg


def train_cases():
    """(label, call) of K4's forward and backward at the timed shape, fp32
    and bf16, then of its non-causal form (``causal=False``, bf16) where
    the checkout has one, then of its bf16 forward at ``TRAIN_FWD_SHAPES``
    and its bf16 backward at ``TRAIN_BWD_SHAPES``."""
    import inspect

    from livecc_tpu_torch.ops.train_attention import train_attention_bwd, train_attention_fwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    hq, hk, d = TRAIN_HEADS
    qs, k, v, do, seg = train_operands(1, TRAIN_S, hq, hk, TRAIN_LENGTHS, gen)
    label = f"S={TRAIN_S} segments {list(TRAIN_LENGTHS)} + pad Hq={hq} Hk={hk} D={d}"
    for dtype in (torch.float32, torch.bfloat16):
        q_, k_, v_, do_ = (x.to(dtype) for x in (qs, k, v, do))
        kind = f"{label} {str(dtype)[6:]}"
        yield (f"K4 fwd {kind}",
               lambda q_=q_, k_=k_, v_=v_: train_attention_fwd(q_, k_, v_, seg))
        o, lse = train_attention_fwd(q_, k_, v_, seg)
        yield (f"K4 bwd {kind}",
               lambda a=(q_, k_, v_, seg, o, lse, do_): train_attention_bwd(*a))
    label += " bfloat16"
    if "causal" in inspect.signature(train_attention_fwd).parameters:
        yield (f"K4 fwd non-causal {label}",
               lambda: train_attention_fwd(qs, k, v, seg, causal=False))
        o, lse = train_attention_fwd(qs, k, v, seg, causal=False)
        yield (f"K4 bwd non-causal {label}",
               lambda: train_attention_bwd(qs, k, v, seg, o, lse, do, causal=False))
    del qs, k, v, do, seg, o, lse
    for name, b, s, hq, hk, lengths in TRAIN_FWD_SHAPES:
        qs, k, v, _, seg = train_operands(b, s, hq, hk, lengths, gen)
        yield (f"K4 fwd {name} B={b} S={s} segments {list(lengths)} + pad Hq={hq} Hk={hk} "
               f"D={d} bfloat16",
               lambda a=(qs, k, v, seg): train_attention_fwd(*a))
        del qs, k, v, seg
    for name, b, s, hq, hk, lengths in TRAIN_BWD_SHAPES:
        qs, k, v, do, seg = train_operands(b, s, hq, hk, lengths, gen)
        o, lse = train_attention_fwd(qs, k, v, seg)
        yield (f"K4 bwd {name} B={b} S={s} segments {list(lengths)} + pad Hq={hq} Hk={hk} "
               f"D={d} bfloat16",
               lambda a=(qs, k, v, seg, o, lse, do): train_attention_bwd(*a))
        del qs, k, v, do, seg, o, lse


# K5's shapes at the 7B: projection -> (N, K, fp32 output); decode rows M = 1
# and 8 and the verify windows M = 9 (B = 1) and 72 (B = 8) on gate_proj,
# down_proj, k_proj and the lm_head (fp32 out); prefill: a steady chunk's
# 256 rows on gate_proj and on down_proj (28 column tiles: a split plan),
# 1024 rows on gate_proj, the pool tick's 2048 on gate_proj and down_proj;
# the ViT's fc1 at 3520 patches
W8_PROJ = {"gate_proj": (18944, 3584, False), "down_proj": (3584, 18944, False),
           "k_proj": (512, 3584, False), "lm_head": (152064, 3584, True),
           "vit_fc1": (5120, 1280, False)}
W8_SHAPES = tuple((name, m) for m in (1, 8, WINDOW_SQ, 8 * WINDOW_SQ)
                  for name in ("gate_proj", "down_proj", "k_proj", "lm_head")) + (
    ("gate_proj", 256), ("down_proj", 256), ("gate_proj", 1024), ("gate_proj", 2048),
    ("down_proj", 2048), ("vit_fc1", 3520))
# the shapes of K5's large form (M > 16 rows)
W8_LARGE_SHAPES = tuple((name, m) for name, m in W8_SHAPES if m > 16)


def w8_operands(name: str, m: int, gen: torch.Generator):
    """(x [M, K] bf16, int8 codes [N, K], bf16 scales [N], out_dtype) of
    K5 at ``W8_PROJ[name]``: x ~ N(0, 1), a weight ~ N(0, 1/K) quantized."""
    from livecc_tpu_torch.ops.quant import quantize_weight

    n, k, fp32_out = W8_PROJ[name]
    dev = gen.device
    x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
    node = quantize_weight((torch.randn((n, k), generator=gen, device=dev) * k ** -0.5)
                           .bfloat16(), scale_axis=-1)
    return x, node["q"], node["scale"].reshape(-1), torch.float32 if fp32_out else None


def w8_work(m: int, n: int, k: int, fp32_out: bool) -> tuple[float, float]:
    """(operations, bytes) of one K5 call: 2 M N K; the codes, x, the output
    and the scales each moved once."""
    return 2.0 * m * n * k, n * k + 2 * m * k + (4 if fp32_out else 2) * m * n + 2 * n


def w8_cases(shapes=W8_SHAPES):
    """(label, call) of K5 at each of ``shapes``."""
    from livecc_tpu_torch.ops.quant import w8a16_gemm

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
    for name, m in shapes:
        x, q, scale, out_dtype = w8_operands(name, m, gen)
        n, k = q.shape
        yield (f"K5 {name} M={m} N={n} K={k} {'fp32' if out_dtype else 'bf16'} out",
               lambda x=x, q=q, s=scale, o=out_dtype: w8a16_gemm(x, q, s, o))


def digest(out) -> str:
    """sha256 of the bytes of a call's output tensors, in order: two
    checkouts' kernels that give the same bits on the same inputs give the
    same digest."""
    h = hashlib.sha256()
    for x in out if isinstance(out, tuple) else (out,):
        h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing: needs a CUDA GPU")
    import livecc_tpu_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout
    result = {"package": livecc_tpu_torch.__path__[0], "card": card.strip(),
              "torch": torch.__version__}
    kinds = {"decode": decode_cases, "decode_tp": decode_tp_cases, "vit": vit_cases,
             "vit_paths": vit_path_cases,
             "prefill": prefill_cases, "prefill_tp": prefill_tp_cases,
             "prefill_int8": prefill_int8_cases, "train": train_cases, "w8": w8_cases,
             "w8_large": lambda: w8_cases(W8_LARGE_SHAPES)}
    unknown = set(argv) - set(kinds)
    if unknown:
        raise SystemExit(f"kernel_timing: unknown kinds {sorted(unknown)}; known: {list(kinds)}")
    for kind, cases in kinds.items():
        if not (kind in argv if argv else kind != "w8_large"):
            continue
        rows = result[kind] = []
        for label, call in cases():
            out = call()
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(x.float()).all())
                       for x in (out if isinstance(out, tuple) else (out,))):
                raise AssertionError(f"{label}: non-finite output")
            rows.append({"case": label, "cuda_ms": cuda_ms(call), "graph_ms": graph_ms(call),
                         "sha256": digest(out)})
            print(f"  {label:60s} one call {rows[-1]['cuda_ms']:.4f} ms  device "
                  f"{rows[-1]['graph_ms']:.4f} ms  outputs {rows[-1]['sha256'][:16]}", flush=True)
            del out
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

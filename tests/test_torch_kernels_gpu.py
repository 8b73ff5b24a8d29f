"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) where
``torch.cuda.is_available()`` is false. On a machine with the card (which
has no jax, so ``tests/conftest.py`` stays out):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

fp32 kernels are held to the plain version in fp32 (max abs 1e-4). bf16
K1, K1-int8, K2 and K3 are held to the plain version in their own dtype by
``kernel_check.close``, a limit that a dropped split of keys (K2) or a
dropped key tile (K1, K1-int8, K3) fails; K2 and K4 also to the plain
version computed in fp32 (max abs 2e-2, the JAX package's bf16 bound).
"""

import pytest
import torch

from livecc_tpu_torch.ops import build
from livecc_tpu_torch.ops.flash_attention import (
    DECODE_SPLIT, flash_decode, flash_decode_plain, flash_prefill, flash_prefill_plain)
from livecc_tpu_torch.tools import kernel_check, kernel_timing
from livecc_tpu_torch.ops.vit_attention import vit_group_attention, vit_group_attention_plain

pytestmark = pytest.mark.gpu
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: python -m pytest -m gpu "
                    "tests/test_torch_kernels_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def assert_close(out, ref, dtype):
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


def assert_tiles_close(out, ref, fault):
    """bf16 K1 / K3 against the plain version on the same inputs in bf16, by
    ``kernel_check.close``; the same limit fails the planted dropped tile."""
    torch.cuda.synchronize()
    assert kernel_check.close(out, ref, torch.bfloat16) <= 1.0
    assert kernel_check.close(fault, ref, torch.bfloat16) > 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ng,g,h,d", [(3, 880, 16, 80), (2, 12, 2, 80), (2, 70, 4, 16)])
def test_vit_group_attention(cuda, dtype, ng, g, h, d):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (randn(gen, (ng, g, h, d), dtype, cuda) for _ in range(3))
    before = build.launch_counts["vit_group_attention"]
    out = vit_group_attention(q, k, v)
    assert build.launch_counts["vit_group_attention"] == before + 1
    ref = vit_group_attention_plain(q, k, v)
    if dtype == torch.float32:
        assert_close(out, ref, dtype)
        return
    cu = list(range(0, (ng + 1) * g, g))
    qn, kn, vn, rn = (x.reshape(ng * g, h, d) for x in (q, k, v, ref))
    fault = kernel_check.vit_drop_key_tile(rn, qn, kn, vn, cu, ng - 1, (g - 1) // 64, g // 128)
    assert_tiles_close(out, ref, fault.view(ref.shape))
    assert torch.equal(out, vit_group_attention(q, k, v))      # no atomics: the same bits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths,h,d", [
    ((880, 308, 544, 100), 16, 80),      # the 7B ViT's heads, partial query and key tiles
    ((1, 64, 65, 200, 7), 4, 16),        # tile edges and a one-row segment
])
def test_vit_segment_attention(cuda, dtype, lengths, h, d):
    """Mixed segment sizes through K3's bounds form (one launch), v a strided
    view of a qkv buffer as the tower holds it."""
    from livecc_tpu_torch.ops.vit_attention import (vit_segment_attention,
                                                    vit_segment_attention_plain)

    gen = torch.Generator(device=cuda).manual_seed(8)
    n = sum(lengths)
    cu = [0]
    for length in lengths:
        cu.append(cu[-1] + length)
    qkv = randn(gen, (n, 3 * h, d), dtype, cuda)
    q, k, v = qkv[:, :h].contiguous(), qkv[:, h:2 * h].contiguous(), qkv[:, 2 * h:]
    cu_t = torch.tensor(cu, dtype=torch.int32, device=cuda)
    before = build.launch_counts["vit_group_attention"]
    out = vit_segment_attention(q, k, v, cu_t, max(lengths))
    assert build.launch_counts["vit_group_attention"] == before + 1
    ref = vit_segment_attention_plain(q, k, v, cu)
    if dtype == torch.float32:
        assert_close(out, ref, dtype)
    else:
        longest = max(range(len(lengths)), key=lambda i: lengths[i])
        g = lengths[longest]
        assert_tiles_close(out, ref, kernel_check.vit_drop_key_tile(
            ref, q, k, v, cu, longest, (g - 1) // 64, g // 128, head=h - 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixed_size_vision_tower(cuda, dtype):
    """The tiny tower on two clips of different grids runs K3's bounds form
    on the card, one launch per block, and agrees with the CPU."""
    import copy

    import numpy as np

    from livecc_tpu_torch.core.config import tiny_config
    from livecc_tpu_torch.models.qwen2_vl import init_params
    from livecc_tpu_torch.ops.rope import vision_rotary_cos_sin
    from livecc_tpu_torch.vision_io.patchify import device_patchify, grid_for_frames

    cfg = tiny_config()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    rng = np.random.RandomState(9)
    clips = [rng.randint(0, 256, size=s, dtype=np.uint8) for s in ((4, 56, 28, 3), (2, 28, 84, 3))]
    grids = [grid_for_frames(*f.shape[:3], cfg.vision) for f in clips]
    seg = np.concatenate([np.repeat(np.arange(t) + 100 * i, hh * ww)
                          for i, (t, hh, ww) in enumerate(grids)]).astype(np.int32)
    cos, sin = (torch.from_numpy(x) for x in vision_rotary_cos_sin(grids, cfg.vision.head_dim))
    args = (torch.cat([device_patchify(torch.from_numpy(f)) for f in clips]), cos, sin,
            torch.from_numpy(seg))
    tower = copy.deepcopy(model.visual).to(dtype)
    with torch.no_grad():
        ref = tower(*args).float()
        before = build.launch_counts["vit_group_attention"]
        out = tower.to(cuda)(*(x.to(cuda) for x in args)).float().cpu()
    assert build.launch_counts["vit_group_attention"] == before + cfg.vision.depth
    rel = (torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref)).item()
    assert rel <= (1e-5 if dtype == torch.float32 else 2e-2), rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hk,d,sq,offsets,limits", [
    (1, 28, 4, 128, 1024, [0], [690]),
    (2, 28, 4, 128, 256, [0, 1500], [200, 1756]),
    (2, 4, 2, 16, 50, [100, 7], [140, 40]),
    (2, 4, 1, 64, 8, [0, 4], [0, 10]),        # a row with no valid key -> 0
])
def test_flash_prefill(cuda, dtype, b, hq, hk, d, sq, offsets, limits):
    gen = torch.Generator(device=cuda).manual_seed(1)
    L, smax = 3, 2048
    k5, v5 = (randn(gen, (L, b, hk, smax, d), dtype, cuda) for _ in range(2))
    q = randn(gen, (b, sq, hq, d), dtype, cuda).transpose(1, 2)     # strided, as the model passes it
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    lim = torch.tensor(limits, dtype=torch.int32, device=cuda)
    before = build.launch_counts["flash_prefill"]
    out = flash_prefill(q, k5, v5, off, lim, layer_index=2)
    assert build.launch_counts["flash_prefill"] == before + 1
    ref = flash_prefill_plain(q, k5[2], v5[2], off, lim)
    if 0 in limits:
        assert not out[limits.index(0)].any()
    if dtype == torch.float32:
        assert_close(out, ref, dtype)
        return
    row = max(range(b), key=lambda i: limits[i])       # the longest row, its last query tile
    qt = (sq - 1) // 64
    kt = min(limits[row], offsets[row] + 64 * qt + 1) // 64 // 2
    fault = kernel_check.drop_key_tile(ref, q, k5[2], v5[2], off, lim, qt, kt, head=hq - 1, row=row)
    assert_tiles_close(out, ref, fault)
    assert torch.equal(out, flash_prefill(q, k5, v5, off, lim, layer_index=2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,offsets,limits", [
    (9, (1500, 37, 0), (1509, 46, 0)),      # verify windows: 16 splits, limits mid-tile, no key
    (256, (690, 0), (946, 200)),            # a chunk; a limit below the chunk's last query
])
def test_flash_prefill_ignores_the_cache_past_kv_limit(cuda, dtype, sq, offsets, limits):
    """Every K and V row at or past a row's limit holds NaN or Inf: the
    kernel's output is finite and within ``kernel_check.close`` (fp32: the
    fp32 limit) of the plain version on the same cache, which reads V there
    as zeros; the 7B's G = 7 at B = 3 and 2."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    b, hq, hk, d, L, smax = len(offsets), 28, 4, 128, 2, 2048
    k5, v5 = (randn(gen, (L, b, hk, smax, d), dtype, cuda) for _ in range(2))
    q = randn(gen, (b, sq, hq, d), dtype, cuda).transpose(1, 2)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    lim = torch.tensor(limits, dtype=torch.int32, device=cuda)
    pos = torch.arange(smax, device=cuda)
    past = (pos[None, :] >= lim[:, None])[None, :, None, :, None]          # [1, B, 1, Smax, 1]
    k5 = k5.masked_fill(past, float("nan"))
    v5 = torch.where(past, torch.where(pos[:, None] % 2 == 1, float("inf"), float("nan")).to(dtype),
                     v5)
    out = flash_prefill(q, k5, v5, off, lim, layer_index=1)
    ref = flash_prefill_plain(q, k5[1], v5[1], off, lim)
    assert bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(ref.float()).all())
    if 0 in limits:
        assert not out[limits.index(0)].any()
    assert kernel_check.close(out, ref, dtype) <= 1.0


def test_bf16_tile_kernels_reject_what_they_do_not_take(cuda):
    """bf16 K1 and K3 run on the tensor cores: a head dim that is not a
    multiple of 16, or rows that 16-byte copies cannot take, raise."""
    from livecc_tpu_torch.ops.vit_attention import vit_segment_attention

    bf16 = torch.bfloat16
    q = torch.zeros(1, 2, 4, 24, device=cuda, dtype=bf16)   # D = 24: a multiple of 8, not 16
    with pytest.raises(ValueError):
        flash_prefill(q, q, q, 0, 4)
    with pytest.raises(ValueError):
        vit_group_attention(q, q, q)
    buf = torch.zeros(1, 2, 4, 36, device=cuda, dtype=bf16)
    q = buf[..., 4:36]                                       # rows 72 bytes apart, base off by 8
    with pytest.raises(ValueError):
        flash_prefill(q, q, q, 0, 4)
    x = torch.zeros(9 * 2 * 32 + 1, device=cuda, dtype=bf16)[1:].view(9, 2, 32)   # base off by 2 bytes
    cu = torch.tensor([0, 4, 9], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        vit_segment_attention(x, x, x, cu, 5)
    with pytest.raises(ValueError):                         # bounds not int32 on the device
        vit_segment_attention(x.clone(), x.clone(), x.clone(), cu.long(), 5)


S = DECODE_SPLIT
# split boundaries, a row of 0 and the cache's end, mixed in one batch
SPLIT_LIMITS = [S - 1, S, S + 1, 4096, 0, 3 * S + 1]


def assert_decode_close(out, ref, dtype):
    """The decode kernels against the plain version on the same inputs in
    the same dtype, by ``kernel_check.close`` (a limit a dropped split fails)."""
    torch.cuda.synchronize()
    worst = kernel_check.close(out, ref, dtype)
    assert worst <= 1.0, worst


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hk,d,limits", [
    (1, 28, 4, 128, [777]), (3, 28, 4, 128, [1, 777, 4096]), (2, 4, 2, 16, [0, 33]),
    (1, 12, 2, 128, [4096]), (6, 28, 4, 128, SPLIT_LIMITS), (6, 4, 2, 16, SPLIT_LIMITS),
])
def test_flash_decode(cuda, dtype, b, hq, hk, d, limits):
    gen = torch.Generator(device=cuda).manual_seed(2)
    L, smax = 2, 4096
    k5, v5 = (randn(gen, (L, b, hk, smax, d), dtype, cuda) for _ in range(2))
    q = randn(gen, (b, 1, hq, d), dtype, cuda).transpose(1, 2)
    lim = torch.tensor(limits, dtype=torch.int32, device=cuda)
    before = build.launch_counts["flash_decode"]
    out = flash_decode(q, k5, v5, lim, layer_index=1)
    assert build.launch_counts["flash_decode"] == before + 1
    assert_decode_close(out, flash_decode_plain(q, k5[1], v5[1], lim), dtype)
    if 0 in limits:
        assert not out[limits.index(0)].any()
    if dtype == torch.bfloat16:       # and against the plain version in fp32
        assert_close(out, flash_decode_plain(q.float(), k5[1].float(), v5[1].float(), lim), dtype)


@pytest.mark.parametrize("quant", [False, True])
def test_flash_decode_launches_are_bit_equal(cuda, quant):
    """No atomics: two launches on the same inputs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, hq, hk, d, smax = 8, 28, 4, 128, 8192
    lim = torch.tensor([1, 777, 8192, 4000, 0, 63, 64, 65], dtype=torch.int32, device=cuda)
    q = randn(gen, (b, 1, hq, d), torch.bfloat16, cuda).transpose(1, 2)
    if quant:
        (k, ks), (v, vs) = (quantized_cache(gen, (b, hk, smax, d), cuda) for _ in range(2))
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = (randn(gen, (b, hk, smax, d), torch.bfloat16, cuda) for _ in range(2))
        kw = {}
    assert torch.equal(flash_decode(q, k, v, lim, **kw), flash_decode(q, k, v, lim, **kw))


def test_flash_decode_rejects_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 4, 1, 20, device=cuda)                # head dim not a multiple of 8
    with pytest.raises(ValueError):
        flash_decode(q, q[:, :2].expand(1, 2, 64, 20), q[:, :2].expand(1, 2, 64, 20), 4)
    q = torch.zeros(1, 3, 1, 16, device=cuda)                # Hq not a multiple of Hk
    k = torch.zeros(1, 2, 64, 16, device=cuda)
    with pytest.raises(ValueError):
        flash_decode(q, k, k, 4)
    k = torch.zeros(1, 2, 64, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_decode(torch.zeros(1, 4, 1, 16, device=cuda).half(), k, k, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hk,d,limits", [
    (1, 32, 1, 128, [3000]),               # G * D = 4096: two sub-groups of 16
    (2, 40, 2, 128, [700, 65]),            # G = 20: sub-groups of 16 and 4
    (2, 48, 1, 96, [1, 4096]),             # G * D = 4608 at D = 96: 21 + 21 + 6 heads
])
def test_flash_decode_wide_group(cuda, dtype, b, hq, hk, d, limits):
    """A query group wider than one decode block runs as sub-groups, one
    launch each, written back into place."""
    from livecc_tpu_torch.ops.flash_attention import decode_subgroups

    gen = torch.Generator(device=cuda).manual_seed(10)
    k5, v5 = (randn(gen, (2, b, hk, 4096, d), dtype, cuda) for _ in range(2))
    q = randn(gen, (b, 1, hq, d), dtype, cuda).transpose(1, 2)
    lim = torch.tensor(limits, dtype=torch.int32, device=cuda)
    before = build.launch_counts["flash_decode"]
    out = flash_decode(q, k5, v5, lim, layer_index=1)
    assert build.launch_counts["flash_decode"] == before + len(decode_subgroups(hq // hk, d))
    assert_decode_close(out, flash_decode_plain(q, k5[1], v5[1], lim), dtype)


def test_decode_entry_refuses_a_workspace_for_another_split(cuda):
    """The C entry point takes nsplit = ceil(Smax / kDecSplit) only, so a
    wrapper that sized the workspace for another split raises; it also
    refuses to run without its arrival counters."""
    lib = build.load_library()
    smax = 2 * DECODE_SPLIT
    q = torch.zeros(1, 4, 1, 16, device=cuda)
    k = torch.zeros(1, 2, smax, 16, device=cuda)
    out = torch.empty_like(q)
    lim = torch.tensor([smax], dtype=torch.int32, device=cuda)
    counters = torch.zeros(2, dtype=torch.int32, device=cuda)
    strides = build.stride_array((q, (0, 1)), (k, (0, 1, 2)), (k, (0, 1, 2)), (out, (0, 1)))
    for nsplit, cnt in ((2, counters), (4, counters), (2, None)):
        ws = torch.empty((2 + 16) * 4 * nsplit, device=cuda)
        err = lib.livecc_flash_decode(0, q.data_ptr(), k.data_ptr(), k.data_ptr(), out.data_ptr(),
                                      lim.data_ptr(), 1, 4, 2, smax, 16, strides, 0.25,
                                      ws.data_ptr(), None if cnt is None else cnt.data_ptr(),
                                      nsplit, None, 0, build.current_stream(cuda))
        assert (err == 0) == (nsplit == 2 and cnt is not None), (nsplit, err)
    torch.cuda.synchronize()
    assert not counters.any()                   # the launch left its counters at zero


def poisoned(x, limits, fill):
    """A copy of cache ``x`` (K / V [B, Hk, S, D] or lane-major scales
    [B, Hk, 1, S]) whose positions at or past each batch row's limit hold
    ``fill``."""
    y = x.clone()
    for i, lim in enumerate(limits):
        if x.shape[-2] == 1:
            y[i, ..., max(lim, 0):] = fill
        else:
            y[i, :, max(lim, 0):] = fill
    return y


@pytest.mark.parametrize("quant", [False, True])
def test_flash_decode_ignores_nan_past_kv_limit(cuda, quant):
    """NaN and Inf in the cache past each row's kv_limit, and past Smax in
    the buffer the cache is a view of (Smax = 4000 leaves the last tile
    64-key tile 32 rows short of it), leave the output bit for bit as it is:
    the kernel reads no row past a limit, and masks what stale rows its last
    tile holds."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    b, hq, hk, d, smax, rows = 6, 28, 4, 128, 4000, 4096
    limits = [1, 777, smax, DECODE_SPLIT + 1, 0, 64]
    lim = torch.tensor(limits, dtype=torch.int32, device=cuda)
    q = randn(gen, (b, 1, hq, d), torch.bfloat16, cuda).transpose(1, 2)
    if quant:
        (k, ks), (v, vs) = (quantized_cache(gen, (b, hk, rows, d), cuda) for _ in range(2))
        clean = (k, v, ks, vs)
        bad = (poisoned(k, limits, 127), poisoned(v, limits, -128),
               poisoned(ks, limits, float("nan")), poisoned(vs, limits, float("inf")))
    else:
        clean = tuple(randn(gen, (b, hk, rows, d), torch.bfloat16, cuda) for _ in range(2))
        bad = (poisoned(clean[0], limits, float("nan")), poisoned(clean[1], limits, float("inf")))
    view = lambda t: t[..., :smax] if t.shape[-2] == 1 else t[:, :, :smax]   # noqa: E731
    clean, bad = tuple(map(view, clean)), tuple(map(view, bad))

    def call(kv):
        return flash_decode(q, kv[0], kv[1], lim, k_scale=kv[2] if quant else None,
                            v_scale=kv[3] if quant else None)

    out = call(clean)
    assert torch.equal(out, call(bad))
    assert_decode_close(out, flash_decode_plain(q, *clean[:2], lim, *clean[2:]), torch.bfloat16)
    assert not out[limits.index(0)].any()


@pytest.mark.parametrize("quant", [False, True])
def test_flash_decode_graph_replay_is_bit_equal(cuda, quant):
    """``flash_decode`` captured in a CUDA graph at the pool's shape, with
    new kv_limit values written in place before each pair of replays: both
    replays give an eager launch's bits and stay within ``close`` of the
    plain version, and the arrival counters are zero after each."""
    from livecc_tpu_torch.ops import flash_attention

    gen = torch.Generator(device=cuda).manual_seed(13)
    b, hq, hk, d, smax = 8, 28, 4, 128, 8192
    q = randn(gen, (b, 1, hq, d), torch.bfloat16, cuda).transpose(1, 2)
    if quant:
        (k, ks), (v, vs) = (quantized_cache(gen, (b, hk, smax, d), cuda) for _ in range(2))
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = (randn(gen, (b, hk, smax, d), torch.bfloat16, cuda) for _ in range(2))
        kw = {}
    lim = torch.tensor(kernel_timing.POOL_LIMITS, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_decode(q, k, v, lim, **kw)         # the eager step before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode(q, k, v, lim, **kw)
    for limits in ([2, 800, 8000, 4100, 0, 65, 513, 3000], [8192] * 8, kernel_timing.POOL_LIMITS):
        lim.copy_(torch.tensor(limits, dtype=torch.int32))
        replays = []
        for _ in range(2):
            graph.replay()
            replays.append(out.clone())
        eager = flash_decode(q, k, v, lim, **kw)
        torch.cuda.synchronize()
        assert torch.equal(replays[0], eager) and torch.equal(replays[1], eager), limits
        ref = flash_decode_plain(q, k, v, lim, kw.get("k_scale"), kw.get("v_scale"))
        assert_decode_close(eager, ref, torch.bfloat16)
        assert not flash_attention._arrival_counters(cuda, b * hk).any()


def test_current_stream_is_the_public_handle(cuda):
    """``build.current_stream`` (the decode wrapper's raw read) equals
    ``torch.cuda.current_stream(...).cuda_stream``, on the default stream
    and under a side stream, for an indexed and an unindexed device."""
    for dev in (cuda, torch.device("cuda", torch.cuda.current_device())):
        assert build.current_stream(dev) == torch.cuda.current_stream(dev).cuda_stream
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            assert build.current_stream(dev) == side.cuda_stream
            assert build.current_stream(dev) == torch.cuda.current_stream(dev).cuda_stream


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 4, 20, device=cuda)              # head dim not a multiple of 8
    with pytest.raises(ValueError):
        flash_prefill(q, q, q, 0, 4)
    q = torch.zeros(1, 2, 4, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_prefill(q, q, q, 0, 4)


def quantized_cache(gen, shape, dev):
    """int8 K or V [..., Smax, D] and its lane-major bf16 scales [..., 1, Smax]."""
    from livecc_tpu_torch.models.qwen2_vl.text import quantize_kv

    codes, scale = quantize_kv(torch.randn(shape, generator=gen, device=dev))
    return codes, scale.transpose(-1, -2).contiguous()


POOL_OFFSETS = list(kernel_timing.INT8_POOL_OFFSETS)        # chip_smoke's timed pool tick
STEADY_OFFSETS = list(kernel_timing.INT8_STEADY_OFFSETS)    # a steady tick, ~1300 deep


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hk,d,sq,offsets,limits", [
    (8, 28, 4, 128, 256, [0, 300, 1500, 7, 64, 900, 1200, 40], [256, 556, 1756, 263, 100, 1156, 1456, 0]),
    (8, 28, 4, 128, 256, POOL_OFFSETS, [o + 256 for o in POOL_OFFSETS]),
    (8, 28, 4, 128, 256, STEADY_OFFSETS, [o + 256 for o in STEADY_OFFSETS]),
    (2, 4, 2, 16, 50, [100, 7], [140, 40]),
    (3, 7, 1, 64, 130, [0, 70, 5], [130, 131, 100]),     # a ragged last query tile, stops mid-chunk
    (1, 28, 4, 128, 1024, [0], [690]),
])
def test_flash_prefill_int8(cuda, dtype, b, hq, hk, d, sq, offsets, limits):
    """fp32 within 1e-4 of the fp32 plain version; bf16 (the tensor-core
    kernel) by ``kernel_check.close`` against the plain version on the same
    bf16 q, a limit that the plain output without one 64-key tile of the
    deepest row fails, two launches bit-equal, and under
    ``kernel_check.FLIP_LIMIT`` of the outputs off the fp32 plain version's
    rounding, a limit that p * v_scale as one bf16 part fails."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    L, smax = 3, 8192
    (k5, ks), (v5, vs) = (quantized_cache(gen, (L, b, hk, smax, d), cuda) for _ in range(2))
    q = randn(gen, (b, sq, hq, d), dtype, cuda).transpose(1, 2)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    lim = torch.tensor(limits, dtype=torch.int32, device=cuda)
    before = build.launch_counts["flash_prefill_int8"]
    out = flash_prefill(q, k5, v5, off, lim, layer_index=2, k_scale=ks, v_scale=vs)
    assert build.launch_counts["flash_prefill_int8"] == before + 1
    layer = (k5[2], v5[2], off, lim, ks[2], vs[2])
    ref = flash_prefill_plain(q, *layer)
    if 0 in limits:
        assert not out[limits.index(0)].any()
    if dtype == torch.float32:
        assert_close(out, ref, dtype)
        return
    row = max(range(b), key=lambda i: limits[i])       # the deepest row, its last query tile
    qt = (sq - 1) // 64
    kt = min(limits[row], offsets[row] + 64 * qt + 1) // 64 // 2
    fault = kernel_check.drop_key_tile(ref, q, k5[2], v5[2], off, lim, qt, kt, head=hq - 1,
                                       row=row, k_scale=ks[2], v_scale=vs[2])
    assert_tiles_close(out, ref, fault)
    assert torch.equal(out, flash_prefill(q, k5, v5, off, lim, layer_index=2, k_scale=ks,
                                          v_scale=vs))
    # p * v_scale kept in fp32 (three bf16 parts), not rounded once: the
    # outputs round as the fp32 plain version's do, save a few
    ref32 = flash_prefill_plain(q.float(), *layer)
    assert kernel_check.rounding_flips(out, ref32) <= kernel_check.FLIP_LIMIT
    one_part = kernel_check.one_part_pv(q, k5[2], v5[2], off, lim, ks[2], vs[2]).to(dtype)
    assert kernel_check.rounding_flips(one_part, ref32) > kernel_check.FLIP_LIMIT


def test_bf16_int8_prefill_rejects_what_it_does_not_take(cuda):
    """bf16 K1-int8 runs on the tensor cores: a head dim that is not a
    multiple of 16, int8 rows that are not 16-byte aligned, or scale rows
    of Smax * 2 bytes that are not a multiple of 16, raise (no FMA route)."""
    bf16, i8 = torch.bfloat16, torch.int8
    q = torch.zeros(1, 2, 4, 24, device=cuda, dtype=bf16)   # D = 24: a multiple of 8, not 16
    k = torch.zeros(1, 1, 64, 24, device=cuda, dtype=i8)
    s = torch.ones(1, 1, 1, 64, device=cuda, dtype=bf16)
    with pytest.raises(ValueError):
        flash_prefill(q, k, k, 0, 4, k_scale=s, v_scale=s)
    q = torch.zeros(1, 2, 4, 16, device=cuda, dtype=bf16)
    buf = torch.zeros(1, 1, 64, 24, device=cuda, dtype=i8)
    k = buf[..., 8:]                                         # rows 24 bytes apart, base off by 8
    with pytest.raises(ValueError):
        flash_prefill(q, k, k, 0, 4, k_scale=s, v_scale=s)
    k = torch.zeros(1, 2, 60, 16, device=cuda, dtype=i8)
    s = torch.ones(1, 2, 1, 60, device=cuda, dtype=bf16)     # scale rows of 120 bytes
    with pytest.raises(ValueError):
        flash_prefill(q, k, k, 0, 4, k_scale=s, v_scale=s)
    out = flash_prefill(q.float(), k, k, 0, 4, k_scale=s, v_scale=s)   # fp32 q: the FMA kernel
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hk,d,limits", [
    (8, 28, 4, 128, [1, 777, 8192, 4000, 0, 63, 64, 65]), (2, 4, 2, 16, [0, 33]),
    (6, 28, 4, 128, SPLIT_LIMITS),
    (6, 4, 2, 8, SPLIT_LIMITS),         # int8 rows of 8 bytes: the kernel's 8-byte loads
])
def test_flash_decode_int8(cuda, dtype, b, hq, hk, d, limits):
    gen = torch.Generator(device=cuda).manual_seed(4)
    L, smax = 2, 8192
    (k5, ks), (v5, vs) = (quantized_cache(gen, (L, b, hk, smax, d), cuda) for _ in range(2))
    q = randn(gen, (b, 1, hq, d), dtype, cuda).transpose(1, 2)
    lim = torch.tensor(limits, dtype=torch.int32, device=cuda)
    before = build.launch_counts["flash_decode_int8"]
    out = flash_decode(q, k5, v5, lim, layer_index=1, k_scale=ks, v_scale=vs)
    assert build.launch_counts["flash_decode_int8"] == before + 1
    assert_decode_close(out, flash_decode_plain(q, k5[1], v5[1], lim, ks[1], vs[1]), dtype)
    if 0 in limits:
        assert not out[limits.index(0)].any()
    if dtype == torch.bfloat16:       # and against the plain version in fp32
        ref32 = flash_decode_plain(q.float(), k5[1], v5[1], lim, ks[1], vs[1])
        assert_close(out, ref32, dtype)
        # p * v_scale kept fp32 (three bf16 parts): the fp32 result's
        # roundings, which p * v_scale as one bf16 part misses (decode's keys
        # are a prefill query's at offset kv_limit - 1)
        assert kernel_check.rounding_flips(out, ref32) <= kernel_check.FLIP_LIMIT
        one_part = kernel_check.one_part_pv(q, k5[1], v5[1], lim - 1, lim, ks[1], vs[1])
        assert kernel_check.rounding_flips(one_part.to(dtype), ref32) > kernel_check.FLIP_LIMIT


def test_int8_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 4, 1, 16, device=cuda)
    k = torch.zeros(1, 2, 64, 16, device=cuda, dtype=torch.int8)
    s = torch.zeros(1, 2, 1, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                         # one scale without the other
        flash_decode(q, k, k, 4, k_scale=s)
    with pytest.raises(ValueError):                         # fp32 scales
        flash_decode(q, k, k, 4, k_scale=s.float(), v_scale=s.float())
    with pytest.raises(TypeError):                          # a bf16 cache with scales
        flash_decode(q, k.bfloat16(), k.bfloat16(), 4, k_scale=s, v_scale=s)


# ---------------------------------------------------------------------------
# K4: the splash training attention, forward and backward
# ---------------------------------------------------------------------------

def train_inputs(gen, b, s, hq, hk, d, dtype, dev, strided_q):
    from livecc_tpu_torch.ops.attention import prescaled

    if strided_q:        # q as the model hands it over: a head-major buffer seen as [B, S, Hq, D]
        q = randn(gen, (b, hq, s, d), dtype, dev).transpose(1, 2)
    else:
        q = randn(gen, (b, s, hq, d), dtype, dev)
    k, v, do = (randn(gen, shape, dtype, dev) for shape in
                ((b, s, hk, d), (b, s, hk, d), (b, s, hq, d)))
    return prescaled(q), k, v, do


def packed_segments(b, s, lengths, dev):
    """int32 [b, s]: segments 1..n of ``lengths`` (one list for every row,
    or one list per row), the rest 0 (pad)."""
    per_row = lengths if isinstance(lengths[0], (list, tuple)) else [lengths] * b
    seg = torch.zeros((b, s), dtype=torch.int32)
    for row, row_lengths in enumerate(per_row):
        at = 0
        for i, n in enumerate(row_lengths):
            seg[row, at:at + n] = i + 1
            at += n
    return seg.to(dev)


def k4_share(out, ref):
    """max |out - ref| / (1e-2 |ref| + 2e-2 rms(ref)): bf16 K4's o against
    the plain version in bf16, which rounds p as the kernel does (the limit
    of chip_smoke.py's K4_TOL); above 1 fails."""
    torch.cuda.synchronize()
    out, ref = out.float(), ref.float()
    lim = 1e-2 * ref.abs() + 2e-2 * ref.square().mean().sqrt()
    return ((out - ref).abs() / lim).max().item()


def grad_share(out, ref, ref32):
    """``kernel_check.grad_close``: a bf16 K4 gradient against the fp32
    plain version, within bf16's rtol plus twice the bf16 plain version's
    worst stray from fp32 in the row plus a thousandth of the gradient's
    rms (chip_smoke.py's phase_k4); above 1 fails."""
    torch.cuda.synchronize()
    return kernel_check.grad_close(out, ref, ref32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hk,d,lengths,strided_q", [
    (1, 1000, 28, 4, 128, [400, 350, 200], True),     # S % 64 != 0, 3 segments + pad
    (2, 256, 4, 2, 32, [256], False),
    (1, 130, 6, 1, 16, [70, 40], True),
    (1, 200, 4, 4, 64, [120, 80], False),
    (1, 17, 4, 2, 16, [10], False),                    # less than one tile
    (2, 300, 8, 2, 128, [[300], [90, 110, 40]], True),  # rows packed differently
    (1, 300, 7, 1, 64, [1, 100, 1, 120], False),       # one-row segments, pad tail
    (1, 640, 7, 1, 80, [200, 150], True),              # all-pad tiles at the end
    (2, 577, 28, 4, 128, [[577], [64, 1, 300]], False),  # a segment ends on a tile edge
])
def test_train_attention(cuda, dtype, b, s, hq, hk, d, lengths, strided_q):
    from livecc_tpu_torch.ops.train_attention import (
        train_attention_bwd, train_attention_bwd_plain, train_attention_fwd,
        train_attention_fwd_plain)

    gen = torch.Generator(device=cuda).manual_seed(5)
    qs, k, v, do = train_inputs(gen, b, s, hq, hk, d, dtype, cuda, strided_q)
    seg = packed_segments(b, s, lengths, cuda)
    before = (build.launch_counts["train_attention_fwd"], build.launch_counts["train_attention_bwd"])
    o, lse = train_attention_fwd(qs, k, v, seg)
    grads = train_attention_bwd(qs, k, v, seg, o, lse, do)
    assert (build.launch_counts["train_attention_fwd"],
            build.launch_counts["train_attention_bwd"]) == (before[0] + 1, before[1] + 1)
    f32 = [x.float() for x in (qs, k, v)]
    ro, rlse = train_attention_fwd_plain(*f32, seg)
    rgrads = train_attention_bwd_plain(*f32, seg, ro, rlse, do.float())
    assert_close(o, ro, dtype)
    torch.testing.assert_close(lse, rlse, atol=TOL[dtype], rtol=0)
    for g, r in zip(grads, rgrads):     # gradients: max abs error against their own scale
        torch.cuda.synchronize()
        assert (g.float() - r).abs().max().item() <= TOL[dtype] * max(1.0, r.abs().max().item())
    if dtype == torch.bfloat16:
        # and elementwise: o against the plain version in bf16, which rounds
        # as the kernels do (|out - ref| <= 1e-2 |ref| + 2e-2 rms(ref)); the
        # gradients against the fp32 plain version within what the bf16
        # plain version's rounding allows (kernel_check.grad_close); the
        # backward's bf16 reference on the backward kernel's own inputs, the
        # forward kernel's o and lse, as in chip_smoke.py's phase_k4
        so, _ = train_attention_fwd_plain(qs, k, v, seg)
        sgrads = train_attention_bwd_plain(qs, k, v, seg, o, lse, do)
        assert k4_share(o, so) <= 1.0
        for out, ref, r32 in zip(grads, sgrads, rgrads):
            assert grad_share(out, ref, r32) <= 1.0
        # no atomics: a second launch gives the same bits
        o2, lse2 = train_attention_fwd(qs, k, v, seg)
        grads2 = train_attention_bwd(qs, k, v, seg, o, lse, do)
        for a, r in zip((o, lse, *grads), (o2, lse2, *grads2)):
            assert torch.equal(a, r)


@pytest.mark.parametrize("run", [37, 5])
def test_train_attention_recurring_ids(cuda, run):
    """Segment ids that recur along the row (runs of ``run`` tokens cycling
    through ids 0, 1, 2, as a mask with gaps gives): a query attends every
    earlier key of its id, across the gaps. Tiles then hold two or three
    ids, so the bf16 kernels' live-tile lists take both their exact and
    their range test. Held elementwise to the plain version in bf16 (o)
    and in fp32 (the gradients, ``kernel_check.grad_close``), and two
    launches bit-equal."""
    from livecc_tpu_torch.ops.train_attention import (
        train_attention_bwd, train_attention_bwd_plain, train_attention_fwd,
        train_attention_fwd_plain)

    gen = torch.Generator(device=cuda).manual_seed(7)
    b, s, hq, hk, d = 1, 700, 7, 1, 128
    qs, k, v, do = train_inputs(gen, b, s, hq, hk, d, torch.bfloat16, cuda, False)
    seg = ((torch.arange(s, device=cuda) // run) % 3).to(torch.int32)[None]
    o, lse = train_attention_fwd(qs, k, v, seg)
    grads = train_attention_bwd(qs, k, v, seg, o, lse, do)
    so, slse = train_attention_fwd_plain(qs, k, v, seg)
    sgrads = train_attention_bwd_plain(qs, k, v, seg, o, lse, do)
    f32 = [x.float() for x in (qs, k, v)]
    rgrads = train_attention_bwd_plain(*f32, seg, *train_attention_fwd_plain(*f32, seg),
                                       do.float())
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, slse, atol=1e-4, rtol=0)
    assert k4_share(o, so) <= 1.0
    for out, ref, r32 in zip(grads, sgrads, rgrads):
        assert grad_share(out, ref, r32) <= 1.0
    again = (*train_attention_fwd(qs, k, v, seg), *train_attention_bwd(qs, k, v, seg, o, lse, do))
    assert all(torch.equal(a, r) for a, r in zip((o, lse, *grads), again))


def test_train_flash_attention_autograd(cuda):
    """The model's entry: autograd through the pre-scale and K4, bf16."""
    from livecc_tpu_torch.ops.attention import train_attention_plain, train_flash_attention

    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (randn(gen, (1, 300, h, 128), torch.bfloat16, cuda).requires_grad_()
               for h in (28, 4, 4))
    mask = torch.arange(300, device=cuda)[None, :] < 260
    w = randn(gen, (1, 300, 28, 128), torch.float32, cuda) * mask[..., None, None]
    (train_flash_attention(q, k, v, mask).float() * w).sum().backward()
    ref = [x.detach().float().requires_grad_() for x in (q, k, v)]
    (train_attention_plain(*ref, mask) * w).sum().backward()
    for x, r in zip((q, k, v), ref):
        assert (x.grad.float() - r.grad).abs().max().item() <= 2e-2 * r.grad.abs().max().item()


def test_train_attention_rejects_what_the_kernels_do_not_take(cuda):
    from livecc_tpu_torch.ops.train_attention import train_attention_fwd

    q = torch.zeros(1, 64, 4, 16, device=cuda)
    seg = torch.ones(1, 64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                         # segment ids not int32
        train_attention_fwd(q, q[:, :, :2], q[:, :, :2], seg.long())
    with pytest.raises(ValueError):                         # Hq not a multiple of Hk
        train_attention_fwd(q, q[:, :, :3], q[:, :, :3], seg)
    with pytest.raises(TypeError):
        train_attention_fwd(q.half(), q[:, :, :2].half(), q[:, :, :2].half(), seg)
    b = torch.zeros(1, 64, 4, 24, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                         # bf16 head dim not a multiple of 16
        train_attention_fwd(b, b[:, :, :2], b[:, :, :2], seg)
    b = torch.zeros(1, 64, 4, 20, device=cuda, dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError):                         # bf16 rows not 16-byte aligned
        train_attention_fwd(b, b[:, :, :2], b[:, :, :2], seg)


def test_tiny_train_step_cuda_matches_cpu(cuda):
    """Three fp32 steps of the tiny model: the CPU (plain versions) and the
    card (K3, K4, fused CE with fp32 logit rows) give the same losses."""
    import numpy as np

    from livecc_tpu_torch.tools.train_session import tiny_train_losses

    np.testing.assert_allclose(tiny_train_losses(cuda), tiny_train_losses("cpu"), rtol=1e-4)

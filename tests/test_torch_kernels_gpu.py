"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) where
``torch.cuda.is_available()`` is false. On a machine with the card:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py -q

bf16 kernels are held to the plain version computed in fp32 on the same
bf16 inputs (max abs 2e-2, the JAX package's bf16 bound); fp32 to 1e-4.
"""

import pytest
import torch

from livecc_tpu_torch.ops import build
from livecc_tpu_torch.ops.flash_attention import (
    flash_decode, flash_decode_plain, flash_prefill, flash_prefill_plain)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ng,g,h,d", [(3, 880, 16, 80), (2, 12, 2, 80), (2, 70, 4, 16)])
def test_vit_group_attention(cuda, dtype, ng, g, h, d):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (randn(gen, (ng, g, h, d), dtype, cuda) for _ in range(3))
    before = build.launch_counts["vit_group_attention"]
    out = vit_group_attention(q, k, v)
    assert build.launch_counts["vit_group_attention"] == before + 1
    assert_close(out, vit_group_attention_plain(q.float(), k.float(), v.float()), dtype)


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
    out = flash_prefill(q, k5, v5, off, lim, layer_index=2)
    ref = flash_prefill_plain(q.float(), k5[2].float(), v5[2].float(), off, lim)
    assert_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hk,d,limits", [
    (1, 28, 4, 128, [777]), (3, 28, 4, 128, [1, 777, 4096]), (2, 4, 2, 16, [0, 33]),
    (1, 12, 2, 128, [4096]),
])
def test_flash_decode(cuda, dtype, b, hq, hk, d, limits):
    gen = torch.Generator(device=cuda).manual_seed(2)
    L, smax = 2, 4096
    k5, v5 = (randn(gen, (L, b, hk, smax, d), dtype, cuda) for _ in range(2))
    q = randn(gen, (b, 1, hq, d), dtype, cuda).transpose(1, 2)
    lim = torch.tensor(limits, dtype=torch.int32, device=cuda)
    out = flash_decode(q, k5, v5, lim, layer_index=1)
    ref = flash_decode_plain(q.float(), k5[1].float(), v5[1].float(), lim)
    assert_close(out, ref, dtype)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hk,d,sq,offsets,limits", [
    (8, 28, 4, 128, 256, [0, 300, 1500, 7, 64, 900, 1200, 40], [256, 556, 1756, 263, 100, 1156, 1456, 0]),
    (2, 4, 2, 16, 50, [100, 7], [140, 40]),
    (1, 28, 4, 128, 1024, [0], [690]),
])
def test_flash_prefill_int8(cuda, dtype, b, hq, hk, d, sq, offsets, limits):
    gen = torch.Generator(device=cuda).manual_seed(3)
    L, smax = 3, 2048
    (k5, ks), (v5, vs) = (quantized_cache(gen, (L, b, hk, smax, d), cuda) for _ in range(2))
    q = randn(gen, (b, sq, hq, d), dtype, cuda).transpose(1, 2)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    lim = torch.tensor(limits, dtype=torch.int32, device=cuda)
    before = build.launch_counts["flash_prefill_int8"]
    out = flash_prefill(q, k5, v5, off, lim, layer_index=2, k_scale=ks, v_scale=vs)
    assert build.launch_counts["flash_prefill_int8"] == before + 1
    ref = flash_prefill_plain(q.float(), k5[2], v5[2], off, lim, ks[2], vs[2])
    assert_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hk,d,limits", [
    (8, 28, 4, 128, [1, 777, 8192, 4000, 0, 63, 64, 65]), (2, 4, 2, 16, [0, 33]),
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
    ref = flash_decode_plain(q.float(), k5[1], v5[1], lim, ks[1], vs[1])
    assert_close(out, ref, dtype)


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

"""K5 (``csrc/w8a16_gemm.cu``), the int8-weight GEMM, on the card.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) where
``torch.cuda.is_available()`` is false. On a machine with the card:

    python -m pytest --noconftest -m gpu tests/test_torch_w8_gpu.py -q

Both bf16 forms (small: M <= 16, split K with a merge pass; large: wgmma
with the weights as A over 128-row tiles, a token tile of 80 or 256 and, where ``quant.large_plan`` splits K, fp32 partials merged in split
order) and the fp32-activation form are held to the plain version
(``ops/quant.py:w8a16_gemm_plain``) on the same inputs in the same dtype by
``kernel_check.close``, in bf16 and with the fp32 output of ``lm_logits``;
a planted fault (``kernel_check.w8_drop_split``, ``w8_drop_k_tile``) must
fail the same limit. Two launches are bit-equal, a captured replay equals
an eager call, no call synchronizes, and a quantized tiny model on the
card decodes the CPU's tokens.
"""

import copy

import pytest
import torch

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.engine import LiveCCEngine
from livecc_tpu_torch.models.qwen2_vl import init_params
from livecc_tpu_torch.ops import build, quant
from livecc_tpu_torch.tools import kernel_check
from livecc_tpu_torch.tools.session import synth_frames

pytestmark = pytest.mark.gpu
BF16, F32 = torch.bfloat16, torch.float32
# (M, N, K): small form at decode rows, large form past 16 rows; N not a
# multiple of 128 (nor of 8) and K not a multiple of 64 included. The large
# shapes reach each token tile unsplit (80: M <= 80, here the B = 8 window's
# 72 rows; 256 above, at M = 100 and with a ragged second tile at M = 300)
# and split plans: k_proj's at the B = 8 window (6 splits), down_proj's at a
# steady prefill chunk (4 splits), M = 24 split 5 ways over K = 1040 (a
# 16-wide last stage)
SMALL = [(1, 512, 3584), (8, 1000, 1040), (9, 3584, 1024), (16, 257, 2048)]
LARGE = [(17, 640, 1280), (72, 1000, 1040), (100, 1000, 1040), (300, 1024, 3584),
         (72, 512, 3584), (256, 3584, 18944), (24, 257, 1040), (2048, 3584, 1280)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_w8_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def operands(m, n, k, dtype, dev, seed=0):
    """x [M, K] ~ N(0, 1), and the codes and scales of a weight ~ N(0, 1/K)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
    node = quant.quantize_weight(w.to(dtype), scale_axis=-1)
    return x, node["q"], node["scale"].reshape(-1)


@pytest.mark.parametrize("out_dtype", [None, F32])
@pytest.mark.parametrize("shape", SMALL + LARGE)
def test_bf16_forms_match_the_plain_version(cuda, shape, out_dtype):
    m, n, k = shape
    x, q, scale = operands(m, n, k, BF16, cuda)
    before = build.launch_counts["w8a16_gemm"]
    out = quant.w8a16_gemm(x, q, scale, out_dtype)
    assert build.launch_counts["w8a16_gemm"] == before + 1
    ref = quant.w8a16_gemm_plain(x, q, scale, out_dtype)
    torch.cuda.synchronize()
    dtype = out_dtype or BF16
    assert out.dtype == ref.dtype == dtype and out.shape == (m, n)
    assert kernel_check.close(out, ref, dtype) <= 1.0
    if m <= quant.SMALL_M:
        fault = kernel_check.w8_drop_split(x, q, scale, out_dtype, block=(n - 1) // 128)
    else:
        tile = quant.large_plan(m, n, k)[0]
        fault = kernel_check.w8_drop_k_tile(x, q, scale, out_dtype, m_block=(m - 1) // tile,
                                            n_block=(n - 1) // quant.LARGE_ROWS)
    assert kernel_check.close(fault, ref, dtype) > 1.0
    assert torch.equal(out, quant.w8a16_gemm(x, q, scale, out_dtype))


@pytest.mark.parametrize("m", [1, 9, 100])
def test_fp32_activations(cuda, m):
    x, q, scale = operands(m, 256, 200, F32, cuda)
    out = quant.w8a16_gemm(x[:, None], q, scale)                  # [M, 1, N]: leading dims kept
    ref = quant.w8a16_gemm_plain(x, q, scale)
    assert out.shape == (m, 1, 256) and out.dtype == F32
    assert kernel_check.close(out[:, 0], ref, F32) <= 1.0


def test_strided_rows_and_refusals(cuda):
    """x may be a view with strided rows (either form); what the kernel does
    not take raises."""
    for m in (8, 72):
        x, q, scale = operands(m, 384, 512, BF16, cuda)
        wide = torch.zeros((m, 1024), dtype=BF16, device=cuda)
        wide[:, :512] = x
        assert torch.equal(quant.w8a16_gemm(wide[:, :512], q, scale),
                           quant.w8a16_gemm(x, q, scale))
    with pytest.raises(ValueError):
        quant.w8a16_gemm(x[:, :504], q[:, :504].contiguous(), scale)   # bf16 K % 16 != 0
    with pytest.raises(ValueError):
        quant.w8a16_gemm(x, q.t().contiguous().t(), scale)         # q not contiguous
    with pytest.raises(ValueError):
        quant.w8a16_gemm(x, q, scale.float())                      # scale not in x's dtype


@pytest.mark.parametrize("m", [1, 72, 256])
def test_captured_replay_equals_eager_and_no_sync(cuda, m):
    x, q, scale = operands(m, 1000, 1024, BF16, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        quant.w8a16_gemm(x, q, scale)                              # warm-up, as capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = quant.w8a16_gemm(x, q, scale)
    for seed in (1, 2):
        x.copy_(operands(m, 1000, 1024, BF16, cuda, seed)[0])
        graph.replay()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = quant.w8a16_gemm(x, q, scale)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(out, eager)


def test_quantized_tiny_engine_decodes_the_cpu_tokens(cuda):
    """The tiny model (fp32) with int8 weights: the engine on the CPU (plain
    versions) and on the card (K5's FMA form, the decode graphs) give the
    same text over 3 chunks."""
    cfg = tiny_config()
    cpu_model = quant.quantize_model(init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    frames = synth_frames(10, 28, 28, seed=1)
    outs = []
    for model in (cpu_model, copy.deepcopy(cpu_model).to(cuda)):
        eng = LiveCCEngine(model, cfg, ByteTokenizer(), cache_len=512, cache_dtype=F32)
        before = build.launch_counts["w8a16_gemm"]
        outs.append(eng.live_cc_once_for_evaluation("describe", frames, max_new_tokens=8))
        launched = build.launch_counts["w8a16_gemm"] - before
        assert launched > 0 if model is not cpu_model else launched == 0
    assert len(outs[0]) == 3 and outs[0] == outs[1]

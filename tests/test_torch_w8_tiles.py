"""K5's large form (``csrc/w8a16_gemm.cu``) on the CPU: its plan and its
arithmetic, tile by tile.

The kernel runs only on the card; what surrounds it is Python that runs
here. ``quant.large_plan`` picks the token tile and the split of K; its
properties are checked over the 7B's shapes and the edges. ``emulate``
repeats the kernel's arithmetic on the plan's tiling: the widened codes as
the A operand, fp32 sums per 64-wide K stage, one fp32 partial per split,
the partials summed in split order, then the plain version's two roundings
(or the fp32 sum times the scale for the lm_head). It is held to JAX's
``dense`` and ``lm_logits`` in fp32 (relative 1e-5, one product) and to
``w8a16_gemm_plain`` in bf16 by ``kernel_check.close``, and the planted
fault of the GPU checks (``kernel_check.w8_drop_k_tile``: one K stage of one
output tile of the plan's tiling) must fail ``close`` at scaled-down shapes
of the same tiling. Inputs are numpy arrays from a seed.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from livecc_tpu.models import qwen2_vl as jm
from livecc_tpu.ops import quant as jq

from livecc_tpu_torch.ops import quant
from livecc_tpu_torch.tools import kernel_check
from test_torch_w8_gpu import LARGE
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.from_numpy
# (N, K) of the 7B's quantized products: q_proj, k_proj, gate_proj,
# down_proj, lm_head; the ViT's qkv, proj, fc1, fc2; the merger's fc1, fc2;
# and edges: N not a multiple of 128 (nor of 8), K not a multiple of 64
SHAPES_NK = [(3584, 3584), (512, 3584), (18944, 3584), (3584, 18944), (152064, 3584),
             (3840, 1280), (1280, 1280), (5120, 1280), (1280, 5120), (5120, 5120),
             (3584, 5120), (1000, 1040), (257, 1040)]
EDGE_M = [17, 72, 80, 81, 256, 2048, 3520]
# scaled-down shapes (M, N, K) of the kernel's tilings: k_proj's 6 splits at
# the B = 8 window; 5 splits with a 16-wide last stage; a 256-token tile
# and a ragged second one; unsplit 80- and 256-token tiles over K = 1040
EMULATED = [(72, 512, 3584), (24, 257, 1040), (300, 640, 1280), (72, 1000, 1040),
            (100, 1000, 1040)]


def splits(k: int, nsplit: int, split_k: int) -> list[tuple[int, int]]:
    return [(s * split_k, min(k, (s + 1) * split_k)) for s in range(nsplit)]


@pytest.mark.parametrize("m", EDGE_M)
def test_large_plan_properties(m):
    for n, k in SHAPES_NK:
        tile, nsplit, split_k = quant.large_plan(m, n, k)
        assert tile in quant.TOKEN_TILES and (tile == 80) == (m <= 80)
        assert -(-m // tile) * tile >= m > (-(-m // tile) - 1) * tile    # the tiles cover M
        ranges = splits(k, nsplit, split_k)
        assert ranges[0][0] == 0 and ranges[-1][1] == k                  # cover K, in order
        assert all(a < b for a, b in ranges)
        assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
        assert split_k % quant.K_TILE == 0                               # whole stages but the last
        units = -(-n // quant.LARGE_ROWS) * -(-m // tile)
        ktiles = -(-k // quant.K_TILE)
        if nsplit > 1:
            assert units * nsplit <= quant.SMS                           # within one wave
            assert 2 * nsplit * m * n * 4 <= n * k                       # partials within the codes
        elif ktiles > 1 and 2 * units <= quant.SMS and 16 * m <= k:
            raise AssertionError(f"({m}, {n}, {k}): {units} tiles, room to split, none")
        quant.large_plan.cache_clear()                                   # the same plan again
        assert quant.large_plan(m, n, k) == (tile, nsplit, split_k)


def test_large_plan_at_the_7b_shapes():
    """No split where the tiles fill the card (gate_proj, the lm_head), a
    split at down_proj and k_proj in the B = 8 window and at down_proj in a
    steady prefill chunk; and the GPU tests' shapes reach every token tile
    and a split."""
    assert quant.large_plan(72, 18944, 3584)[1] == 1
    assert quant.large_plan(72, 152064, 3584)[1] == 1
    assert quant.large_plan(72, 3584, 18944) == (80, 4, 4736)
    assert quant.large_plan(72, 512, 3584) == (80, 6, 640)
    assert quant.large_plan(256, 3584, 18944) == (256, 4, 4736)
    plans = [quant.large_plan(*shape) for shape in LARGE]
    assert {tile for tile, _, _ in plans} == set(quant.TOKEN_TILES)
    assert any(nsplit > 1 for _, nsplit, _ in plans)


def emulate(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """K5's large form, tile by tile on its plan: per output tile (token
    tile x 128 columns) and split, fp32 sums of the widened codes' products
    stage by stage; the splits' partials summed in split order; then the
    fp32 sum times the scale (fp32 out) or rounded, scaled, rounded again."""
    m, (n, k) = x.shape[0], q.shape
    tile, nsplit, split_k = quant.large_plan(m, n, k)
    xf, wf = x.float(), q.to(x.dtype).float()              # the codes are exact in bf16
    partials = torch.zeros((nsplit, m, n))
    for m0 in range(0, m, tile):
        for n0 in range(0, n, quant.LARGE_ROWS):
            rows, cols = slice(m0, m0 + tile), slice(n0, n0 + quant.LARGE_ROWS)
            for s, (k0, k1) in enumerate(splits(k, nsplit, split_k)):
                acc = torch.zeros((min(m, m0 + tile) - m0, min(n, n0 + quant.LARGE_ROWS) - n0))
                for ks in range(k0, k1, quant.K_TILE):
                    ke = min(k1, ks + quant.K_TILE)
                    acc += xf[rows, ks:ke] @ wf[cols, ks:ke].T
                partials[s, rows, cols] = acc
    total = torch.zeros((m, n))
    for s in range(nsplit):                                # the merge's fixed order
        total += partials[s]
    if out_dtype == torch.float32 or x.dtype == torch.float32:
        return total * scale.float()
    return (total.to(x.dtype) * scale).to(x.dtype)


def operands(m, n, k, seed=0):
    """x [M, K] ~ N(0, 1) and JAX's codes and scale of a weight [K, N] ~ N(0, 1/K)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    node = jq.quantize_weight(jnp.asarray(rng.randn(k, n).astype(np.float32) * k ** -0.5),
                              scale_axis=-2)
    return x, node


@pytest.mark.parametrize("shape", EMULATED)
def test_emulation_matches_jax_in_fp32(shape):
    """fp32 x: the tiled, split and merged sums against JAX's ``dense`` and,
    with the fp32 output, against ``lm_logits`` on an untied int8 lm_head."""
    m, n, k = shape
    x, node = operands(m, n, k)
    q = T(np.asarray(node["q"]).T.copy())                  # [N, K], the port's layout
    scale = T(np.array(node["scale"], np.float32).reshape(-1))
    ref = np.asarray(jq.dense(jnp.asarray(x), node))
    out = emulate(T(x), q, scale).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    ref = np.asarray(jm.lm_logits({"lm_head": {"kernel": node}},
                                  types.SimpleNamespace(tie_word_embeddings=False),
                                  jnp.asarray(x[None])))[0]
    out = emulate(T(x), q, scale, torch.float32).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
@pytest.mark.parametrize("shape", EMULATED)
def test_emulation_within_close_of_the_plain_version_and_the_fault_fails(shape, out_dtype):
    """bf16 x: the emulation within ``kernel_check.close``'s limit of
    ``w8a16_gemm_plain`` (bf16 out, or fp32 as ``lm_logits``), and one
    dropped K stage of the last output tile (``w8_drop_k_tile``) past it."""
    m, n, k = shape
    x, node = operands(m, n, k, seed=1)
    xb = T(x).bfloat16()
    q = T(np.asarray(node["q"]).T.copy())
    scale = T(np.array(node["scale"], np.float32).reshape(-1)).bfloat16()
    dtype = out_dtype or torch.bfloat16
    ref = quant.w8a16_gemm_plain(xb, q, scale, out_dtype)
    out = emulate(xb, q, scale, out_dtype)
    assert out.dtype == ref.dtype == dtype
    assert kernel_check.close(out, ref, dtype) <= 1.0
    tile = quant.large_plan(m, n, k)[0]
    fault = kernel_check.w8_drop_k_tile(xb, q, scale, out_dtype, m_block=(m - 1) // tile,
                                        n_block=(n - 1) // quant.LARGE_ROWS)
    assert kernel_check.close(fault, ref, dtype) > 1.0

"""Weight-only int8 for serving (per-output-channel symmetric), and K5.

Port of ``livecc_tpu/ops/quant.py``. A decode step reads every matmul
weight for a handful of rows, so its time is the weights' bytes: int8 codes
with one scale per output channel halve them (the 7B's 15.4 GiB of bf16
weights become ~7.7 GiB). Training stays bf16, as in JAX: the quantized
modules hold no ``Parameter``, and a gradient through one raises.

Two layouts. The functions the tests hold to JAX keep JAX's: a quantized
weight is a dict ``{"q": int8, "scale": ...}`` whose scale reduces the
contraction axis (``quantize_weight``; ``dense`` takes ``[in, out]``
kernels with a ``[1, out]`` scale, ``embed_lookup`` and ``vocab_kernel`` a
``[V, H]`` table with a ``[V, 1]`` scale). The modules keep the port's
``[out, in]``: ``QuantLinear`` holds ``q [out, in]`` and ``scale [out]``,
``QuantEmbedding`` ``q [V, H]`` and ``scale [V]``, as buffers, and
``jax_weight(module)`` gives either module's weight in JAX's layout as
views, so ``[out, in]`` is what reaches the kernel without a copy: the
untied lm_head and the tied embedding are both its ``[N, K]`` operand.

``w8a16_gemm(x, q, scale)`` is K5 (``csrc/w8a16_gemm.cu``), ``x [..., K] @
q[N, K]^T * scale[N]``: on CUDA tensors the kernel (bf16 x: a split-K
tensor-core GEMV for M <= ``SMALL_M`` rows; above, wgmma with the weights
as A over 128-row weight tiles and a token tile of ``TOKEN_TILES``, split
in K where the tiles do not fill the card, ``large_plan``; fp32 x: an FMA
loop), on CPU tensors ``w8a16_gemm_plain``, JAX's formula step by step;
any other device raises. The kernel launches on the current stream,
makes no host sync and takes its workspace from the torch allocator here,
so the decode graphs capture it.

``quantize_model(model)`` quantizes a ``Qwen2VL`` in place, module by
module, the set JAX's ``quantize_model_params`` quantizes: the 7 kernels of
every text layer, the embedding, the untied lm_head, the 4 kernels of every
ViT block and the merger's two; ``patch_embed``, the norms and the biases
(moved into the quantized modules as buffers) stay as they are.
"""

from __future__ import annotations

import functools
from typing import Any, Union

import torch
from torch import nn

from livecc_tpu_torch.ops import build

Quantized = dict  # {"q": int8 tensor, "scale": tensor}, JAX's layout
Weight = Union[torch.Tensor, Quantized]

#: decoder-layer modules quantized by quantize_model (JAX ``_LAYER_KERNELS``:
#: q_kernel, k_kernel, v_kernel, o_kernel, gate_kernel, up_kernel, down_kernel)
LAYER_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
#: ViT-block modules (JAX ``_VIT_BLOCK_KERNELS``: qkv, proj, fc1, fc2) and the merger's
VIT_BLOCK_LINEARS = ("qkv", "proj", "fc1", "fc2")
MERGER_LINEARS = ("fc1", "fc2")

# K5's small form (csrc/w8a16_gemm.cu): rows it takes, columns a block owns,
# k per slab; the splits aim at TARGET_BLOCKS blocks (4 on each of 132 SMs)
SMALL_M, SMALL_BLOCK_N, K_TILE, TARGET_BLOCKS = 16, 128, 64, 528
# K5's large form: weight rows a block (wgmma's m: two warpgroups of 64), the
# token tiles (wgmma's n) and the card's SMs (one block each: ~200 KB of
# shared memory)
LARGE_ROWS, TOKEN_TILES, SMS = 128, (80, 256), 132


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "scale" in w


def quantize_weight(w: torch.Tensor, scale_axis: int = -2) -> Quantized:
    """Symmetric int8 with a weight-dtype scale per kept channel, bit for
    bit JAX's: ``scale = max(amax, 1e-8) / 127`` in fp32, rounded to the
    weight's dtype BEFORE the codes ``round(w / scale)`` (fp32, half to
    even) are taken and clipped to +-127. ``scale_axis`` is the contraction
    axis the scale reduces over: -2 for JAX's ``[..., in, out]`` kernels,
    -1 for a ``[V, H]`` table or the port's ``[out, in]`` weights. One fp32
    copy of ``w`` is the only temporary of its size (amax as the larger of
    max and -min; the codes taken in place), so quantizing the 7B's
    embedding holds 2.2 GB beside it, not three times that."""
    w32 = w.to(torch.float32, copy=True)
    amax = torch.maximum(w32.amax(dim=scale_axis, keepdim=True),
                         -w32.amin(dim=scale_axis, keepdim=True))
    scale = (torch.clamp(amax, min=1e-8) / 127.0).to(w.dtype)
    q = w32.div_(scale.float()).round_().clamp_(-127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _check_w8a16(x, q, scale) -> None:
    if q.dtype != torch.int8 or q.ndim != 2 or x.shape[-1] != q.shape[1]:
        raise ValueError(f"w8a16_gemm: x {tuple(x.shape)} and int8 q [N, K] = "
                         f"{q.dtype} {tuple(q.shape)} do not fit")
    if scale.shape != (q.shape[0],) or scale.dtype != x.dtype:
        raise ValueError(f"w8a16_gemm: scale must be [N] = [{q.shape[0]}] in x's dtype "
                         f"{x.dtype}, got {scale.dtype} {tuple(scale.shape)}")


def w8a16_gemm_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of K5, JAX's formula step by step: ``(x @
    q.astype(x.dtype)) * scale`` in x's dtype (two roundings), or with
    ``out_dtype=torch.float32`` the fp32 sum of the widened operands times
    the fp32 scale (``lm_logits``)."""
    _check_w8a16(x, q, scale)
    if out_dtype == torch.float32:
        return (x.float() @ q.float().t()) * scale.float()
    if out_dtype not in (None, x.dtype):
        raise ValueError(f"w8a16_gemm: out_dtype {out_dtype} (x's dtype or float32)")
    return (x @ q.to(x.dtype).t()) * scale


def small_split(n: int, k: int) -> tuple[int, int]:
    """(nsplit, split_k) of K5's small form for N columns over K: the K
    range is cut into ``nsplit`` splits of ``split_k`` (a multiple of 64, the
    last one shorter) so that N / 128 column blocks times the splits come
    near ``TARGET_BLOCKS``."""
    tiles = -(-k // K_TILE)
    want = max(1, min(tiles, -(-TARGET_BLOCKS // -(-n // SMALL_BLOCK_N))))
    per = -(-tiles // want)
    return -(-tiles // per), per * K_TILE


@functools.lru_cache(maxsize=4096)
def large_plan(m: int, n: int, k: int) -> tuple[int, int, int]:
    """(token_tile, nsplit, split_k) of K5's large form for M tokens, N
    columns and K. A block computes one 128-column x ``token_tile`` output
    tile over one of ``nsplit`` ranges of ``split_k`` (a multiple of 64, the
    last one shorter) of K. The token tile is 80 up to 80 tokens (the B =
    8 verify window's 72) and 256 above: every tile of tokens rereads the
    weights and every tile of columns rereads x, and those reads from L2,
    not the last partial wave, were what bounded the form at the 7B's
    prefill shapes on the H100. Where the tiles do not fill one wave of
    132 blocks, K is split into as many ranges as keep the blocks within the
    wave, while the fp32 partials, written and read once (``2 * nsplit * M
    * N * 4`` bytes), stay within the codes' ``N * K``; the merge sums them
    in split order."""
    tile = TOKEN_TILES[0] if m <= TOKEN_TILES[0] else TOKEN_TILES[1]
    ktiles, units = -(-k // K_TILE), -(-n // LARGE_ROWS) * -(-m // tile)
    want = max(1, min(ktiles, SMS // units, k // (8 * m)))
    per = -(-ktiles // want)
    return tile, -(-ktiles // per), per * K_TILE


def w8a16_gemm(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """K5: ``x [..., K] @ q[N, K]^T * scale[N]`` -> ``[..., N]`` in x's
    dtype, or fp32 with ``out_dtype=torch.float32``. x is bf16 or fp32,
    q int8 and contiguous, scale in x's dtype."""
    if x.device.type == "cpu":
        return w8a16_gemm_plain(x, q, scale, out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"w8a16_gemm: no kernel for device {x.device}")
    _check_w8a16(x, q, scale)
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"w8a16_gemm: x dtype {x.dtype} not supported (float32, bfloat16)")
    if out_dtype not in (None, x.dtype, torch.float32):
        raise ValueError(f"w8a16_gemm: out_dtype {out_dtype} (x's dtype or float32)")
    if q.device != x.device or scale.device != x.device or not q.is_contiguous() \
            or not scale.is_contiguous():
        raise ValueError("w8a16_gemm: q and scale must be contiguous, on x's device")
    n, k = q.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if x2.stride(-1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        x2 = x2.contiguous()
    m = x2.shape[0]
    out_fp32 = out_dtype == torch.float32 or x.dtype == torch.float32
    out = torch.empty((m, n), dtype=torch.float32 if out_fp32 else x.dtype, device=x.device)
    if x.dtype == torch.bfloat16 and (k % 16 or q.data_ptr() % 16):
        raise ValueError(f"w8a16_gemm: bf16 needs K a multiple of 16 and a 16-byte aligned q, "
                         f"got K {k}, q base {q.data_ptr() % 16} mod 16")
    tile, nsplit, split_k, partial = 0, 1, -(-k // K_TILE) * K_TILE, None
    if x.dtype == torch.bfloat16:
        if m <= SMALL_M:
            nsplit, split_k = small_split(n, k)
        else:
            tile, nsplit, split_k = large_plan(m, n, k)
        if tile == 0 or nsplit > 1:
            partial = torch.empty((nsplit, m, n), dtype=torch.float32, device=x.device)
    lib = build.load_library()
    with build.on_device(x.device):
        build.launch("w8a16_gemm", lib.livecc_w8a16_gemm, build.DTYPE_CODES[x.dtype],
                     int(out_fp32), x2.data_ptr(), x2.stride(0), q.data_ptr(), scale.data_ptr(),
                     out.data_ptr(), 0 if partial is None else partial.data_ptr(), m, n, k,
                     tile, split_k, nsplit, build.current_stream(x.device))
    return out.reshape(*lead, n)


def dense(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """``x @ w`` for a plain ``[in, out]`` kernel or a quantized node
    (``q [in, out]``, ``scale [1, out]``): ``(x @ q) * scale`` through K5,
    which takes ``q``'s transpose, the port's ``[out, in]`` storage."""
    if is_quantized(w):
        return w8a16_gemm(x, w["q"].t(), w["scale"].reshape(-1).to(x.dtype))
    return x @ w


def embed_lookup(w: Weight, ids: torch.Tensor) -> torch.Tensor:
    """Row gather from a plain or quantized ``[V, H]`` table; a quantized
    row is its codes in the scale's dtype times the row's scale."""
    if is_quantized(w):
        return w["q"][ids].to(w["scale"].dtype) * w["scale"][ids]
    return w[ids]


def vocab_kernel(w: Weight, transpose: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(kernel ``[H, V]``, per-column scale ``[1, V]`` or None) for
    ``lm_logits``: ``transpose=True`` for the tied ``[V, H]`` embedding,
    False for an ``[H, V]`` lm_head kernel (views, no copies)."""
    if is_quantized(w):
        q, s = w["q"], w["scale"]
        return (q.t() if transpose else q), s.reshape(1, -1)
    return (w.t() if transpose else w), None


class QuantLinear(nn.Module):
    """``nn.Linear``'s place with int8 ``q [out, in]`` and ``scale [out]``
    (the model dtype) and an optional bias, all buffers. ``forward`` is
    ``dense`` and then ``+ bias`` in the activation dtype, JAX's two steps
    (``text.py:192-205``, ``vision.py:126-142``)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    @staticmethod
    @torch.no_grad()
    def from_linear(linear: nn.Linear) -> "QuantLinear":
        node = quantize_weight(linear.weight, scale_axis=-1)
        bias = None if linear.bias is None else linear.bias.detach().clone()
        return QuantLinear(node["q"], node["scale"].reshape(-1), bias)

    def jax_weight(self) -> Quantized:
        return {"q": self.q.t(), "scale": self.scale[None]}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError("QuantLinear: int8 weights are for serving; training stays in "
                               "the model dtype (build the model without quantize_weights)")
        y = dense(x, self.jax_weight())
        return y if self.bias is None else y + self.bias


class QuantEmbedding(nn.Module):
    """``nn.Embedding``'s place with int8 ``q [V, H]`` and ``scale [V]``,
    buffers. A tied lm_head reads the same ``q`` as K5's ``[N, K]``."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @staticmethod
    @torch.no_grad()
    def from_embedding(embed: nn.Embedding) -> "QuantEmbedding":
        node = quantize_weight(embed.weight, scale_axis=-1)
        return QuantEmbedding(node["q"], node["scale"].reshape(-1))

    def jax_weight(self) -> Quantized:
        return {"q": self.q, "scale": self.scale[:, None]}

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embed_lookup(self.jax_weight(), ids)


def jax_weight(module: nn.Module) -> Weight:
    """A linear or embedding module's weight in JAX's layout: a plain
    ``nn.Linear`` kernel ``[in, out]`` (a view), an ``nn.Embedding`` table,
    or a quantized module's node."""
    if isinstance(module, (QuantLinear, QuantEmbedding)):
        return module.jax_weight()
    if isinstance(module, nn.Linear):
        return module.weight.t()
    if isinstance(module, nn.Embedding):
        return module.weight
    raise TypeError(f"jax_weight: {type(module).__name__} is no linear or embedding module")


def quantized_sites(model: nn.Module) -> list[tuple[nn.Module, str]]:
    """(parent, attribute) of every module ``quantize_model`` quantizes, in
    JAX's order: text layers, embedding, untied lm_head, ViT blocks, merger."""
    text, visual = model.text, model.visual
    sites = [(layer, name) for layer in text.layers for name in LAYER_LINEARS]
    sites.append((text, "embed"))
    if text.lm_head is not None:
        sites.append((text, "lm_head"))
    sites += [(blk, name) for blk in visual.blocks for name in VIT_BLOCK_LINEARS]
    sites += [(visual.merger, name) for name in MERGER_LINEARS]
    return sites


@torch.no_grad()
def quantize_model(model: nn.Module) -> nn.Module:
    """Quantize a ``Qwen2VL``'s matmul weights in place (``quantized_sites``)
    and return it. One module at a time: each bf16 weight is freed once its
    codes exist, so the device holds the model plus one module's
    temporaries, never both models. Modules already quantized are kept.

    A model split over more than one model rank
    (``parallel/sharding.py:shard_params``) raises: o and down hold a slice
    of their input channels there, whose amax is not the whole channel's,
    so their codes would differ from the unsplit model's. Quantize first,
    then shard, as JAX does."""
    tp = model.text.tp
    plain = any(isinstance(getattr(p, n), (nn.Linear, nn.Embedding))
                for p, n in quantized_sites(model))
    if tp is not None and tp.size > 1 and plain:
        raise ValueError(f"quantize_model on a model split over {tp.size} model ranks: quantize "
                         f"the whole model, then shard_params")
    for parent, name in quantized_sites(model):
        mod = getattr(parent, name)
        if isinstance(mod, nn.Linear):
            setattr(parent, name, QuantLinear.from_linear(mod))
        elif isinstance(mod, nn.Embedding):
            setattr(parent, name, QuantEmbedding.from_embedding(mod))
        del mod
    return model

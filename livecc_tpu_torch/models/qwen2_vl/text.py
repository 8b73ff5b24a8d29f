"""Qwen2 LLM tower (GQA + SwiGLU + RMSNorm + M-RoPE) with a static KV cache.

Port of the cached path of ``livecc_tpu/models/qwen2_vl/text.py``
(transformers Qwen2VLTextModel semantics). The cache keeps the JAX layout
``[L, B, Hk, Smax, D]`` with a per-row int32 ``offset [B]`` and is **updated
in place**: each layer writes the chunk's K/V at every row's offset *before*
attention (as ``text.py:286-302``), then attends through K1
``flash_prefill`` (s > 1) or K2 ``flash_decode`` (s == 1) on the stacked
cache and the layer index — no per-layer slice is copied. An int8 cache
(``KVCache.zeros(dtype=torch.int8)``) quantizes each chunk's K/V before the
write (``quantize_kv``, as ``text.py:288-313``) and runs the int8 kernels.
Without a cache ``text_forward`` is the training forward: every layer
attends through K4 ``train_flash_attention`` over the whole sequence.
A layer's linears may be ``ops/quant.py:QuantLinear`` (int8 weights, K5),
the serving configuration; ``lm_logits`` takes a quantized vocab kernel.

Under tensor parallelism (``parallel/sharding.py:shard_params`` sets
``tp`` on the tower and its layers) a layer holds its model rank's Hq / M
query heads, Hk / M KV heads and I / M of the MLP width (Megatron's
layout): ``copy_to_model`` in front of q / k / v and gate / up,
``reduce_from_model`` after o and down (``parallel/tp.py``). Serving runs
so too: the cache holds the rank's Hk / M heads (``KVCache.zeros(tp=)``),
K1 / K2 attend on its Hq / M query heads, and ``lm_logits`` gathers the
rank's vocab columns into the whole logits on every rank.

Sequence parallelism (``text_forward(seq_shard=True)``, training on a
split tower; JAX's ``seq_shard``) shards the residual stream along the
sequence over the model group at every layer boundary: the tower splits
the sequence after the embeddings (``split_to_sequence``), each layer
gathers in front of q / k / v and gate / up and reduce-scatters after o
and down (``parallel/tp.py``), and the last layer's output is gathered
whole (``gather_sequence_exit``) in front of the final norm. The norms and
the residual adds hold S / M rows; attention sees the whole sequence on
the rank's heads, and M-RoPE's cos / sin stay whole. Where M does not
divide S the sequence is padded inside the forward (masked keys, segment
0) and cut after the exit gather. A norm weight's gradient on a rank is
then its block's part: the step sums them over the model group
(``train/step.py:make_mesh_train_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from livecc_tpu_torch.core.config import TextConfig
from livecc_tpu_torch.models.qwen2_vl.layers import RMSNorm
from livecc_tpu_torch.ops.attention import train_flash_attention
from livecc_tpu_torch.ops.flash_attention import flash_decode, flash_prefill
from livecc_tpu_torch.ops.quant import jax_weight, vocab_kernel, w8a16_gemm
from livecc_tpu_torch.ops.rope import apply_mrope, mrope_cos_sin
from livecc_tpu_torch.parallel.tp import (
    TensorParallel, copy_to_model, gather_from_model, gather_from_sequence, gather_sequence_exit,
    reduce_from_model, reduce_scatter_to_sequence, split_to_sequence)


@dataclasses.dataclass
class KVCache:
    """Static-size KV cache in attention layout with PER-ROW offsets.

    ``k``/``v`` (and the scales) are written in place by ``text_forward``;
    ``offset`` is replaced (never mutated) by the callers that advance it.

    ``zeros(dtype=torch.int8)`` makes a QUANTIZED cache: symmetric int8 per
    (position, head) with bf16 scales, half the KV bytes of bf16. The scales
    are lane-major ``[L, B, Hk, 1, Smax]`` as in JAX (positions on the last
    axis), so the int8 kernels read one contiguous scale row per key tile.
    A tower split over the model axis (``tp``) caches its rank's Hk / M
    heads."""

    k: torch.Tensor         # [L, B, Hk, Smax, D]
    v: torch.Tensor         # [L, B, Hk, Smax, D]
    offset: torch.Tensor    # int32 [B]
    k_scale: Optional[torch.Tensor] = None    # [L, B, Hk, 1, Smax] bf16 (int8 cache)
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[-2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def zeros(cfg: TextConfig, batch: int, max_len: int, dtype=torch.float32,
              device=None, tp: Optional[TensorParallel] = None) -> "KVCache":
        heads = cfg.num_key_value_heads // (1 if tp is None else tp.size)
        shape = (cfg.num_hidden_layers, batch, heads, max_len, cfg.head_dim)
        offset = torch.zeros((batch,), dtype=torch.int32, device=device)
        kv = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(2)]
        if dtype == torch.int8:
            sshape = shape[:-2] + (1, max_len)
            scales = [torch.zeros(sshape, dtype=torch.bfloat16, device=device) for _ in range(2)]
            return KVCache(*kv, offset, *scales)
        return KVCache(*kv, offset)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 [..., D], bf16 scale [..., 1]); symmetric per row.

    As JAX ``quantize_kv``: amax, scale and ``x / scale`` are computed in
    the INPUT dtype (bf16 arithmetic for a bf16 model), rounded half to
    even, clipped to +-127; the scale is stored as bf16 after the codes were
    taken with it."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def write_rows(cache_layer: torch.Tensor, rows: torch.Tensor, start: torch.Tensor) -> None:
    """In place: ``cache_layer[b, :, start[b] + i] = rows[b, :, i]`` for a
    one-layer view [B, Hk, Smax, D] and rows [B, Hk, s, D]; every row at its
    own depth, with no host sync. A lane-major scale layer [B, Hk, 1, Smax]
    is written through its transposed view [B, Hk, Smax, 1] (JAX
    ``_write_scale``)."""
    b, hk, s, _ = rows.shape
    dev = rows.device
    pos = start.long()[:, None] + torch.arange(s, device=dev)[None, :]            # [B, s]
    bi = torch.arange(b, device=dev)[:, None, None]
    hi = torch.arange(hk, device=dev)[None, :, None]
    cache_layer[bi, hi, pos[:, None, :]] = rows.to(cache_layer.dtype)


class DecoderLayer(nn.Module):
    """Pre-norm attention + residual, pre-norm SwiGLU MLP + residual.
    ``tp`` (None: the whole layer) is its model group under tensor
    parallelism. ``seq`` (sequence parallelism, training only) says that
    ``x`` is this model rank's block of the sequence: the norms and the
    residual adds run on the block, the column-split products on the
    gathered sequence, and the row-split products' partial sums are
    reduce-scattered back to the block."""

    def __init__(self, cfg: TextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h, i = cfg.hidden_size, cfg.intermediate_size
        kvd = cfg.num_key_value_heads * cfg.head_dim
        self.cfg = cfg
        self.tp: Optional[TensorParallel] = None
        self.input_ln = RMSNorm(h, cfg.rms_norm_eps, **kw)
        self.post_ln = RMSNorm(h, cfg.rms_norm_eps, **kw)
        self.q_proj = nn.Linear(h, h, **kw)
        self.k_proj = nn.Linear(h, kvd, **kw)
        self.v_proj = nn.Linear(h, kvd, **kw)
        self.o_proj = nn.Linear(h, h, bias=False, **kw)
        self.gate_proj = nn.Linear(h, i, bias=False, **kw)
        self.up_proj = nn.Linear(h, i, bias=False, **kw)
        self.down_proj = nn.Linear(i, h, bias=False, **kw)

    def _split_in(self, y: torch.Tensor, seq: bool) -> torch.Tensor:
        if self.tp is None:
            return y
        return gather_from_sequence(y, self.tp) if seq else copy_to_model(y, self.tp)

    def _split_out(self, y: torch.Tensor, seq: bool) -> torch.Tensor:
        if self.tp is None:
            return y
        return reduce_scatter_to_sequence(y, self.tp) if seq else reduce_from_model(y, self.tp)

    def qkv(self, x, seq: bool = False) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Pre-norm q, k, v projections (bias included), [B, S, heads, D]."""
        y = self._split_in(self.input_ln(x), seq)
        b, s, _ = y.shape
        return tuple(proj(y).reshape(b, s, -1, self.cfg.head_dim)
                     for proj in (self.q_proj, self.k_proj, self.v_proj))

    def attention(self, q, k, v, cos, sin, attend, seq: bool = False) -> torch.Tensor:
        """M-RoPE, attention and the output projection: [B, S, H]."""
        b, s = q.shape[:2]
        q, k = apply_mrope(q, k, cos, sin)
        return self._split_out(self.o_proj(attend(q, k, v).reshape(b, s, -1)), seq)

    def gate_up(self, x, seq: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """gate and up of the post-norm input: [B, S, I] each."""
        y = self._split_in(self.post_ln(x), seq)
        return self.gate_proj(y), self.up_proj(y)

    def mlp_in(self, x, seq: bool = False) -> torch.Tensor:
        """silu(gate) * up of the post-norm input: [B, S, I]."""
        gate, up = self.gate_up(x, seq)
        return F.silu(gate) * up

    def down(self, h, seq: bool = False) -> torch.Tensor:
        """The down projection of silu(gate) * up: [B, S, H]."""
        return self._split_out(self.down_proj(h), seq)

    def forward(self, x, cos, sin, attend, seq: bool = False) -> torch.Tensor:
        x = x + self.attention(*self.qkv(x, seq), cos, sin, attend, seq)
        return x + self.down(self.mlp_in(x, seq), seq)


class TextModel(nn.Module):
    def __init__(self, cfg: TextConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.tp: Optional[TensorParallel] = None
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device, dtype)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device=device, dtype=dtype)
        self.lm_head = None
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                     device=device, dtype=dtype)


def text_forward(
    model: TextModel,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,     # [B, S, H]
    position_ids: torch.Tensor,      # [3, B, S] int
    cache: KVCache | None = None,
    kv_limit: torch.Tensor | None = None,   # int32 [B]: keys < kv_limit valid
    attention_mask: torch.Tensor | None = None,   # uncached: bool [B, S] or int32 segment ids
    remat: bool | str = False,
    seq_shard: bool = False,
) -> tuple[torch.Tensor, KVCache | None]:
    """Returns (final hidden states [B, S, H], the cache with offset + S).

    The cache's K/V buffers are written in place (every layer writes its
    chunk at each row's offset, then attends); ``kv_limit`` defaults to
    offset + S. Decode (S == 1) runs K2, everything else K1.

    Without a cache (training, JAX ``text.py:342-367``) every layer attends
    through ``train_flash_attention`` (K4, splash semantics) and the cache
    returned is None. ``remat=True`` checkpoints each layer
    (``torch.utils.checkpoint``, JAX's ``nothing_saveable``): the backward
    re-runs the layer, K4's forward included. The named policies "names",
    "names_mlp" and "dots" keep some products' outputs (``remat_layer``).
    ``seq_shard`` (uncached, on a tower split by ``shard_params``) runs
    sequence parallelism over its model group; without a model group it
    raises."""
    b, s, _ = inputs_embeds.shape
    cos, sin = mrope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta, cfg.mrope_section)
    cos = cos.to(inputs_embeds.dtype)
    sin = sin.to(inputs_embeds.dtype)
    if cache is None:
        return _uncached_forward(model, inputs_embeds, cos, sin, attention_mask, remat,
                                 seq_shard), None
    if kv_limit is None:
        kv_limit = cache.offset + s
    # a slab that would run past the end lands at Smax - s, as JAX's
    # dynamic_update_slice clamps its start
    start = torch.clamp(cache.offset, max=cache.max_len - s)

    x = inputs_embeds
    for li, layer in enumerate(model.layers):
        def attend(q, k, v, li=li):
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)            # [B, Hk, s, D]
            if cache.quantized:
                kt, ks = quantize_kv(kt)                             # scales [B, Hk, s, 1]
                vt, vs = quantize_kv(vt)
                write_rows(cache.k_scale[li].transpose(-1, -2), ks, start)
                write_rows(cache.v_scale[li].transpose(-1, -2), vs, start)
            write_rows(cache.k[li], kt, start)
            write_rows(cache.v[li], vt, start)
            qt = q.transpose(1, 2)                                   # [B, Hq, s, D]
            scales = dict(k_scale=cache.k_scale, v_scale=cache.v_scale)
            if s == 1:
                out = flash_decode(qt, cache.k, cache.v, kv_limit, layer_index=li, **scales)
            else:
                out = flash_prefill(qt, cache.k, cache.v, cache.offset, kv_limit,
                                    layer_index=li, **scales)
            return out.transpose(1, 2)                               # [B, s, Hq, D]

        x = layer(x, cos, sin, attend)
    cache.offset = cache.offset + s
    return model.final_ln(x), cache


REMAT_POLICIES = (False, True, "names", "names_mlp", "dots")


def check_remat(remat) -> None:
    """Raise on a ``remat`` that is not one of ``REMAT_POLICIES``."""
    if not any(remat is p or (isinstance(p, str) and remat == p) for p in REMAT_POLICIES):
        raise ValueError(f"remat={remat!r}: expected one of {REMAT_POLICIES}")


def _region(fn, *args):
    """``fn(*args)`` as a checkpoint region: its inputs are kept for the
    backward, everything inside it is recomputed there. Recomputation stops
    once the last tensor the region's backward needs is saved again, an
    input of the region's last product, so that product is not run again."""
    return checkpoint(fn, *args, use_reentrant=False)


def remat_layer(layer: DecoderLayer, x, cos, sin, attend, remat, seq=False) -> torch.Tensor:
    """One decoder layer under a named remat policy (JAX ``remat_policy``
    and ``decoder_block``'s tags, ``text.py:143-205``), as explicit
    checkpoint regions between the tensors the policy keeps: what a policy
    keeps is a region's input, the rest is recomputed in the backward, K4's
    forward always (as splash's in JAX: its residuals are not nameable).

      * "names" keeps q, k and v and x + o_proj (JAX: o_proj's output, the
        same bytes);
      * "names_mlp" keeps silu(gate) * up besides;
      * "dots" keeps every product's output (JAX's
        ``dots_with_no_batch_dims_saveable``: q, k, v, x + o_proj, gate and
        up; down's output is read by no backward).

    JAX's ``remat_down`` names a tensor no backward reads, so no region
    keeps it. The regions split the layer's ops and never run one twice,
    so the backward graph is remat=True's and so are the gradients, bit
    for bit on deterministic kernels. That costs recomputed products JAX
    skips: the q / k / v region reruns q and k (v is its last), "dots"'s
    gate / up region reruns gate."""
    q, k, v = _region(layer.qkv, x, seq)
    x = x + _region(layer.attention, q, k, v, cos, sin, attend, seq)
    if remat == "names":
        return x + _region(lambda x_: layer.down(layer.mlp_in(x_, seq), seq), x)
    if remat == "names_mlp":
        return x + layer.down(_region(layer.mlp_in, x, seq), seq)
    gate, up = _region(layer.gate_up, x, seq)
    return x + _region(lambda g, u: layer.down(F.silu(g) * u, seq), gate, up)


def run_layers(layers, x, cos, sin, attend, remat, seq: bool = False) -> torch.Tensor:
    """``layers`` in order over ``x`` under the remat policy ``remat``
    (``REMAT_POLICIES``) while gradients are on; ``seq``: ``x`` is this
    model rank's sequence block (``DecoderLayer``)."""
    for layer in layers:
        if not remat or not torch.is_grad_enabled():
            x = layer(x, cos, sin, attend, seq)
        elif remat is True:
            x = checkpoint(layer, x, cos, sin, attend, seq, use_reentrant=False)
        else:
            x = remat_layer(layer, x, cos, sin, attend, remat, seq)
    return x


def _pad_sequence(x, cos, sin, attention_mask, m: int):
    """Pad dim 1 of the residual stream, cos / sin and the mask to a
    multiple of ``m``: the pad rows are masked keys (False) or segment 0,
    so no real row attends to them; they are cut after the exit gather."""
    pad = -x.shape[1] % m
    if not pad:
        return x, cos, sin, attention_mask
    b, s = x.shape[:2]
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.bool, device=x.device)
    return (F.pad(x, (0, 0, 0, pad)), F.pad(cos, (0, 0, 0, pad)), F.pad(sin, (0, 0, 0, pad)),
            F.pad(attention_mask, (0, pad)))


def _uncached_forward(model: TextModel, x, cos, sin, attention_mask, remat,
                      seq_shard: bool = False) -> torch.Tensor:
    """Every layer over the whole sequence, attention through K4, under the
    remat policy ``remat`` (``REMAT_POLICIES``) while gradients are on;
    ``seq_shard``: sequence parallelism over the tower's model group."""
    check_remat(remat)
    s = x.shape[1]
    if seq_shard:
        if model.tp is None:
            raise ValueError("seq_shard: sequence parallelism needs a tower split over a model "
                             "group (parallel/sharding.py:shard_params on a mesh)")
        x, cos, sin, attention_mask = _pad_sequence(x, cos, sin, attention_mask, model.tp.size)
        x = split_to_sequence(x, model.tp)

    def attend(q, k, v):
        return train_flash_attention(q, k, v, attention_mask)

    x = run_layers(model.layers, x, cos, sin, attend, remat, seq_shard)
    if seq_shard:
        x = gather_sequence_exit(x, model.tp)[:, :s]
    return model.final_ln(x)


def lm_logits(model: TextModel, cfg: TextConfig, hidden: torch.Tensor) -> torch.Tensor:
    """[B, S, H] -> [B, S, V] in float32, never rounded to the model dtype
    (JAX's ``preferred_element_type=float32``, ``text.py:370-380``). A bf16
    or fp32 vocab kernel: on CUDA one cuBLAS product of the model-dtype
    operands with an fp32 output; on the CPU (the test path, which has no
    such kernel) an fp32 product of the widened operands. An int8 one (tied
    or untied, ``ops/quant.py``): the fp32 sum times the fp32 scale, K5's
    fp32-output form on its ``[V, H]`` codes. On a vocab-split tower each
    model rank computes its ``[.., V / M]`` columns by the same route and
    the all-gather gives every rank the whole ``[.., V]``."""
    if cfg.tie_word_embeddings:
        kernel, scale = vocab_kernel(jax_weight(model.embed), transpose=True)
    else:
        kernel, scale = vocab_kernel(jax_weight(model.lm_head), transpose=False)
    flat = hidden.reshape(-1, hidden.shape[-1])
    if scale is not None:
        out = w8a16_gemm(flat, kernel.t(), scale.reshape(-1).to(flat.dtype),
                         out_dtype=torch.float32)
    elif flat.device.type == "cuda" and flat.dtype != torch.float32:
        out = torch.mm(flat, kernel, out_dtype=torch.float32)
    else:
        out = torch.mm(flat.float(), kernel.float())
    if model.tp is not None:
        out = gather_from_model(out, model.tp)
    return out.reshape(*hidden.shape[:-1], out.shape[-1])

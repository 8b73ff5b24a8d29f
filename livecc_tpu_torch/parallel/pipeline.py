"""Pipeline-parallel training (GPipe fill-drain over the mesh's model axis).

Port of ``livecc_tpu/parallel/pipeline.py``. The LLM's layers are split
over the model axis by index: stage ``s`` of ``P`` owns layers
``[s L / P, (s + 1) L / P)`` (``pp_split``, JAX's ``pp_param_pspecs``);
everything else is replicated. The model axis carries stages here instead
of tensor-parallel shards: the two are alternative uses of one axis, and
the data axis keeps its meaning beside either (each data rank its own
batch rows, ZeRO-2 over the data group).

JAX writes the schedule as a ``lax.scan`` over ticks inside ``shard_map``
and takes gradients by autodiff through it; the port runs it explicitly,
one process a stage:

  * forward, microbatch by microbatch (the accumulation dim A of the
    Batch): stage 0 embeds, every stage runs its layers (K4 attention,
    per-layer remat as ``TrainConfig.remat``) and sends the activation to
    the next stage (point-to-point over the model group), keeping each
    microbatch's input and output;
  * after the drain, the last stage's hidden states are broadcast over the
    model group (JAX: a ``psum`` with one contributor), every stage runs
    the final norm and the vocab-parallel CE
    (``ops/chunked_ce.py:vocab_parallel_ce``) on its ``[H, V / P]`` column
    slice of the head, V padded to a multiple of P with the pad columns
    masked; loss and count are summed over the data group. JAX runs the
    CE once over all A x B rows; the port runs it a microbatch at a time,
    as the mesh step does, so a logit tile spans B rows and not A x B (the
    same sums in another order; JAX's one call holds A times the logit
    tiles at once);
  * backward: the stages' partial gradients of the hidden states are
    summed onto the last stage (the ``psum``'s transpose), then the
    microbatches run backward in reverse order, gradients hopping stage
    s + 1 -> s;
  * each backward's gradients leave for ZeRO-2's partition as autograd
    completes them (``parallel/sharding.py:Zero2`` with ``pp_split``,
    per stage over the data group; ``Zero2.grad_hooks``, naming the
    parameters the CE's backwards reach and those the layers' backwards
    reach, so each reduces only its own buckets); after the window
    the partition's replicated leaves (the embedding, the final norm, the
    head, tied or not) are summed over the model group, which is JAX's
    shard_map transpose: the tied embedding collects stage 0's lookup
    gradient and every stage's CE slice. The global norm counts the layers
    of every stage and the replicated leaves once.

Every rank issues the same collectives in the same order, and the
point-to-point calls pair up along the chain of stages; at P = 1 none is
issued. Text-only, as JAX's: vision fields are refused (the recipe freezes
the ViT). No CLI flag (JAX has none): a script builds the mesh, calls
``shard_params_pp`` and ``Zero2(..., split=pp_split)``, then the step.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.core.mesh import Mesh
from livecc_tpu_torch.models.qwen2_vl.text import run_layers
from livecc_tpu_torch.ops.attention import train_flash_attention
from livecc_tpu_torch.ops.chunked_ce import IGNORE_INDEX, vocab_parallel_ce
from livecc_tpu_torch.ops.quant import QuantEmbedding, QuantLinear, embed_lookup, jax_weight
from livecc_tpu_torch.ops.rope import mrope_cos_sin
from livecc_tpu_torch.parallel.tp import TensorParallel


def pp_split(name: str) -> Optional[int]:
    """The layer index of parameter ``name`` (the port's names) where the
    pipeline splits it over the model axis, or None where it is replicated
    (JAX ``pp_param_pspecs``: the stacked layers' leading axis)."""
    if name.startswith("text.layers."):
        return int(name.split(".", 3)[2])
    return None


def stage_layers(cfg: ModelConfig, n_stage: int, stage: int) -> range:
    """The layers stage ``stage`` of ``n_stage`` owns; raises where the
    stages do not divide the layers (JAX's assert)."""
    n = cfg.text.num_hidden_layers
    if n % n_stage:
        raise ValueError(f"num_hidden_layers {n} must divide into {n_stage} stages")
    per = n // n_stage
    return range(stage * per, (stage + 1) * per)


class OtherStage(nn.Module):
    """The place of a layer another stage owns: no parameters; calling it
    raises."""

    def __init__(self, index: int, stage: int):
        super().__init__()
        self.index, self.stage = index, stage

    def forward(self, *args, **kw):
        raise RuntimeError(f"layer {self.index} lives on pipeline stage {self.stage}")


@torch.no_grad()
def shard_params_pp(model: nn.Module, cfg: ModelConfig, mesh: Mesh) -> None:
    """Keep this stage's layers of ``model`` and drop the others (their
    modules become ``OtherStage``, so their storage is freed once nothing
    else holds it); the rest stays whole. Raises where the stages do not
    divide the layers, on a tower already split for tensor parallelism,
    and on int8 weights (which do not train)."""
    own = stage_layers(cfg, mesh.n_model, mesh.m)
    if model.text.tp is not None:
        raise ValueError("shard_params_pp: the tower is split for tensor parallelism; pipeline "
                         "stages and TP shards are alternative uses of the model axis")
    quantized = [n for n, mod in model.named_modules()
                 if isinstance(mod, (QuantLinear, QuantEmbedding))]
    if quantized:
        raise NotImplementedError(f"int8 weights do not train ({quantized[0]}, ...)")
    per = len(own)
    for i in range(cfg.text.num_hidden_layers):
        if i not in own:
            model.text.layers[i] = OtherStage(i, i // per)


def _vocab_columns(model: nn.Module, cfg: ModelConfig, stage: int, n_stage: int) -> torch.Tensor:
    """This stage's ``[H, V / P]`` columns of the CE head (the tied
    embedding's or the lm_head's rows, transposed), V padded with zero
    columns to a multiple of P; gradients flow to the rows."""
    text = model.text
    weight = text.embed.weight if cfg.text.tie_word_embeddings else text.lm_head.weight
    v = weight.shape[0]
    per = -(-v // n_stage)
    rows = weight[min(stage * per, v):min((stage + 1) * per, v)]
    if rows.shape[0] < per:
        rows = F.pad(rows, (0, 0, 0, per - rows.shape[0]))
    return rows.t()


def make_pp_train_step(cfg: ModelConfig, tcfg, optimizer, mesh: Mesh, zero):
    """Pipeline-parallel ``step(model, opt_state, batch) -> (model,
    opt_state, metrics)`` over this rank's batch rows: ``model`` cut by
    ``shard_params_pp``, its trainable parameters the views of ``zero``
    (``Zero2(..., split=pp_split)``), ``opt_state`` ``zero.init_state``'s.
    The Batch's accumulation dim A is the microbatch stream (the bubble is
    (P - 1) / (A + P - 1) of the ticks). Every rank calls it once a window;
    ``loss`` and ``tokens`` are global numbers (``train/step.py``'s
    metrics)."""
    from livecc_tpu_torch.train.step import _ce_route

    n_stage, stage = mesh.n_model, mesh.m
    own = stage_layers(cfg, n_stage, stage)
    if tcfg.ce_sup_bucket:
        raise ValueError("make_pp_train_step: ce_sup_bucket is not supported (the pipeline's "
                         "CE runs over every position, as JAX's)")
    if tcfg.seq_shard:
        raise ValueError("make_pp_train_step: seq_shard splits the sequence over the model "
                         "axis, which the pipeline's stages occupy")
    group = mesh.model_group
    last = mesh.rank - stage + n_stage - 1          # the last stage's global rank
    tp = TensorParallel(group, stage, n_stage)      # the CE's vocab split over the stages
    replicated = [n for n in zero.names if pp_split(n) is None]
    t = cfg.text
    # the parameters each kind of backward reaches on this stage, which
    # ZeRO-2's buckets of that backward hold (the same on every data rank)
    head = "text.embed.weight" if t.tie_word_embeddings else "text.lm_head.weight"
    ce_names = [n for n in zero.names if n in ("text.final_ln.weight", head)]
    layer_names = [n for n in zero.names
                   if (n.startswith("text.layers.") and int(n.split(".")[2]) in own)
                   or (stage == 0 and n == "text.embed.weight")]

    def step(model: nn.Module, opt_state: dict, batch):
        if batch.vision_patches is not None or batch.image_patches is not None:
            raise ValueError("make_pp_train_step is text-only (the frozen-ViT recipe): the "
                             "batch carries vision fields")
        loss_sum, count = schedule(model, batch)
        zero.sum_over_model(replicated)
        ints = torch.stack([count, torch.zeros_like(count)])                # count, dropped
        dist.all_reduce(loss_sum, group=mesh.data_group)
        dist.all_reduce(ints, group=mesh.data_group)
        denom = torch.clamp(ints[0], min=1).float()
        opt_state = zero.update(optimizer, opt_state, denom)
        metrics = {"loss": loss_sum / denom, "tokens": ints[0], "ce_dropped": ints[1]}
        return model, opt_state, metrics

    def schedule(model: nn.Module, batch):
        """The window's forwards and backwards (fill, drain, CE, backward);
        returns this rank's loss sum and supervised count."""
        text = model.text
        layers = [text.layers[i] for i in own]
        a_n, b, s = batch.input_ids.shape
        dev, dtype = batch.input_ids.device, text.final_ln.weight.dtype
        stash = []
        for a in range(a_n):
            micro = batch.micro(a)
            cos, sin = mrope_cos_sin(micro.position_ids, t.head_dim, t.rope_theta,
                                     t.mrope_section)
            mask = micro.attention_mask

            def attend(q, k, v, mask=mask):
                return train_flash_attention(q, k, v, mask)

            if stage == 0:
                x = embed_lookup(jax_weight(text.embed), micro.input_ids.long())
            else:
                x = torch.empty((b, s, t.hidden_size), dtype=dtype, device=dev)
                dist.recv(x, src=mesh.rank - 1, group=group)
                x.requires_grad_()
            y = run_layers(layers, x, cos.to(dtype), sin.to(dtype), attend, tcfg.remat)
            if stage < n_stage - 1:
                dist.send(y.detach().contiguous(), dst=mesh.rank + 1, group=group)
            stash.append((x, y))

        # the drain: the last stage's hidden states on every stage, then the
        # final norm and the vocab-parallel CE on each stage's columns, one
        # microbatch at a time (its logit tiles and gradients freed before
        # the next, as the mesh step's)
        if stage == n_stage - 1:
            outs = torch.stack([y.detach() for _, y in stash])              # [A, B, S, H]
        else:
            outs = torch.empty((a_n, b, s, t.hidden_size), dtype=dtype, device=dev)
        if n_stage > 1:
            dist.broadcast(outs, src=last, group=group)
        outs.requires_grad_()
        shifted = torch.cat([batch.labels[..., 1:], torch.full_like(batch.labels[..., :1],
                                                                     IGNORE_INDEX)], dim=-1)
        logit_dtype = _ce_route(tcfg, dev)[1]
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        with zero.grad_hooks(ce_names):
            for a in range(a_n):
                kernel = _vocab_columns(model, cfg, stage, n_stage)
                loss, n = vocab_parallel_ce(text.final_ln(outs[a]), kernel, shifted[a], tp=tp,
                                            v_total=t.vocab_size, chunk_size=tcfg.ce_chunk_size,
                                            logit_dtype=logit_dtype,
                                            kernel_grad=kernel.requires_grad)
                loss.backward()
                zero.accumulate()
                loss_sum += loss.detach()
                count += n
        d_outs = outs.grad
        if n_stage > 1:
            dist.reduce(d_outs, dst=last, group=group)

        with zero.grad_hooks(layer_names):
            for a in reversed(range(a_n)):
                x, y = stash[a]
                if stage == n_stage - 1:
                    g = d_outs[a]
                else:
                    g = torch.empty_like(y)
                    dist.recv(g, src=mesh.rank + 1, group=group)
                torch.autograd.backward(y, g)
                zero.accumulate()
                if stage > 0:
                    dist.send(x.grad.contiguous(), dst=mesh.rank - 1, group=group)
                stash[a] = None
        return loss_sum, count

    return step

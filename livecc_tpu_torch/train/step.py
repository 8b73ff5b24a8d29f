"""Single-GPU training step: AdamW + cosine/warmup, grad accumulation, remat.

Port of ``livecc_tpu/train/step.py`` (no mesh: one card). The semantics are
optax's, not ``torch.optim``'s defaults:

  * the schedule is ``warmup_cosine_decay_schedule(0 -> lr, warmup =
    max(int(total * ratio), 1))`` read at the PRE-increment count, so the
    first update has learning rate 0 and leaves the params as they were;
  * ``clip_by_global_norm(max_grad_norm)`` first, then Adam with bias
    correction at count + 1 and eps outside the sqrt, then
    ``add_decayed_weights``, then ``-lr``;
  * the moments are fp32 (``adam_mu_dtype`` sets the first one's): optax
    allocates them in the param dtype, but its first update promotes them
    with the fp32 gradients and keeps them so, and only ``mu_dtype`` casts
    the first back;
  * gradients are accumulated over the micro-batches in fp32 buffers (JAX's
    ``zeros(..., float32)`` carry), each micro-batch's ``.grad`` added and
    dropped at once, never summed in a bf16 ``.grad``; the window's sum is
    divided by its total supervised-token count.

The frozen modules (``freeze_modules``, the ViT by default) get no grad
buffers and no optimizer state; parameters are updated in place.

The route follows the device: on CUDA the CE runs ``impl="fused"`` with
bf16 logit rows (the TPU defaults, or ``CE_IMPL`` / ``CE_LOGITS``), on the
CPU ``impl="scan"`` in fp32; ``ce_impl`` and ``ce_logits`` pin them.

On a mesh (``make_mesh_train_step``, JAX's step under its (data, model)
shardings, ``train/step.py:222-262``): each data rank runs its own batch
rows through the model-split tower (``parallel/sharding.py:shard_params``)
and the vocab-parallel CE (``ops/chunked_ce.py:vocab_parallel_ce``, the
same logit rows); inside ``Zero2.grad_hooks`` each ``.grad`` leaves for
the data rank's fp32 partition during the backward (reduced over the data
group once a micro-step), then the step sums loss and supervised count
over the data group, divides the gradient by the global count, clips by
the norm of the whole logical gradient and updates its own partition, then
all-gathers the parameters. ``loss`` and ``tokens`` are global numbers.
Under ``seq_shard`` each model rank's norm-weight gradients are its
sequence block's part; the step sums them over the model group once a
window (``Zero2.sum_over_model``, on the partition).

JAX's training switches are read at import as JAX reads them: ``CE_LOGITS``
(``bf16`` | ``f32``) and ``CE_IMPL`` (``fused`` | ``scan``) set the CUDA
route where ``TrainConfig`` leaves ``ce_logits`` / ``ce_impl`` None (the
CPU stays ``scan`` in fp32); ``TRAIN_ATTN`` is ``ops/attention.py``'s.
An unknown value raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from livecc_tpu_torch.core.config import ModelConfig, env_switch
from livecc_tpu_torch.models.qwen2_vl.model import Qwen2VL, VisionInputs, forward
from livecc_tpu_torch.models.qwen2_vl.text import check_remat
from livecc_tpu_torch.ops.chunked_ce import IGNORE_INDEX, chunked_cross_entropy, vocab_parallel_ce
from livecc_tpu_torch.parallel.sharding import is_sequence_partial
from livecc_tpu_torch.parallel.tp import copy_to_model


def ce_switches() -> tuple[str, str]:
    """JAX's ``CE_LOGITS`` and ``CE_IMPL`` (``train/step.py:37,42``): the
    CE's logit rows and autodiff strategy on CUDA where ``TrainConfig``
    leaves them None."""
    return (env_switch("CE_LOGITS", "bf16", ("bf16", "f32")),
            env_switch("CE_IMPL", "fused", ("fused", "scan")))


CE_LOGITS, CE_IMPL = ce_switches()          # read at import, as JAX reads them


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors the reference recipe (scripts/pt_local.sh:17-31)."""

    learning_rate: float = 2e-5
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    adam_mu_dtype: Optional[torch.dtype] = None   # None: fp32
    max_grad_norm: float = 1.0
    freeze_modules: tuple[str, ...] = ("visual",)
    ce_chunk_size: int = 1024
    # CE autodiff strategy: None = by device (CUDA CE_IMPL, "fused" by default; CPU "scan")
    ce_impl: Optional[str] = None
    # CE logit rows: None = by device (CUDA CE_LOGITS, "bf16" by default; CPU "f32"),
    # or "bf16"/"f32"
    ce_logits: Optional[str] = None
    # gather only the supervised positions into a [ce_sup_bucket] buffer
    # before the vocab projection; overflow is dropped and counted
    ce_sup_bucket: Optional[int] = None
    # per-layer rematerialization (the reference's --gradient_checkpointing):
    # True (full recompute), False, or JAX's named policies "names",
    # "names_mlp", "dots" (models/qwen2_vl/text.py:remat_layer)
    remat: bool | str = True
    # sequence parallelism on a mesh with a model axis (Megatron SP, JAX's
    # seq_shard): the residual stream sharded along the sequence over the
    # model group (models/qwen2_vl/text.py); the same numbers as without it
    seq_shard: bool = False

    def __post_init__(self):
        check_remat(self.remat)


def lr_schedule(cfg: TrainConfig):
    """optax ``warmup_cosine_decay_schedule`` as a function of the count,
    in float32 arithmetic as optax evaluates it."""
    f32 = np.float32
    warmup = max(int(cfg.total_steps * cfg.warmup_ratio), 1)
    decay = max(cfg.total_steps, warmup + 1) - warmup
    peak = f32(cfg.learning_rate)

    def schedule(count: int) -> float:
        if count < warmup:
            frac = f32(1) - f32(max(count, 0)) / f32(warmup)
            return float(-peak * frac + peak)
        t = f32(min(count - warmup, decay))
        return float(peak * (f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / f32(decay)))))

    return schedule


def split_frozen(model: Qwen2VL, freeze_modules: tuple[str, ...]):
    """(trainable, frozen) ``{name: parameter}`` split by top-level module
    (train.py:17-19 freezes by module name). Sets ``requires_grad`` to match:
    only the trainable parameters get gradients."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        keep = name.split(".")[0] not in freeze_modules
        p.requires_grad_(keep)
        (trainable if keep else frozen)[name] = p
    return trainable, frozen


def _rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (as JAX casts a Python scalar to an array's dtype)."""
    return float(torch.tensor(x, dtype=dtype))


class AdamW:
    """optax ``chain(clip_by_global_norm, adamw)`` over a ``{name: param}``
    dict, updating the params in place. State: ``{"count": int, "mu": {...},
    "nu": {...}}``; nu is fp32 and mu ``adam_mu_dtype`` (fp32 by default),
    the dtypes optax's state holds from its first update on (its zeros in
    the param dtype are the same numbers)."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.schedule = lr_schedule(cfg)

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        mu_dtype = self.cfg.adam_mu_dtype or torch.float32
        return {
            "count": 0,
            "mu": {n: torch.zeros_like(p, dtype=mu_dtype) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
        }

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: dict,
               params: dict[str, torch.Tensor],
               g_norm: Optional[torch.Tensor] = None) -> dict:
        """Apply one update from fp32 ``grads`` (consumed: clipped in place);
        returns the new state. ``g_norm`` replaces the global norm of
        ``grads`` (a ZeRO partition's caller passes the whole gradient's)."""
        cfg = self.cfg
        count = state["count"]
        lr = self.schedule(count)
        # bias corrections at count + 1, in float32 as optax computes them
        t = np.float32(count + 1)
        c1 = float(np.float32(1) - np.float32(cfg.adam_b1) ** t)
        c2 = float(np.float32(1) - np.float32(cfg.adam_b2) ** t)
        # clip_by_global_norm: g / norm * max_norm where norm >= max_norm (in
        # place on the fp32 grads, which the update consumes)
        if g_norm is None:
            g_norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
        keep = g_norm < cfg.max_grad_norm
        one = torch.ones_like(g_norm)
        den = torch.where(keep, one, g_norm)
        num = torch.where(keep, one, torch.full_like(g_norm, cfg.max_grad_norm))
        for name, p in params.items():
            g = grads[name].float().div_(den).mul_(num)
            mu, nu = state["mu"][name], state["nu"][name]
            # decay * moment in the moment's dtype, decay rounded to it first:
            # optax's weakly typed scalar product (matters for a bf16 mu)
            m = g * (1.0 - cfg.adam_b1) + (mu * _rounded(cfg.adam_b1, mu.dtype)).float()
            v = g.square_() * (1.0 - cfg.adam_b2) + (nu * _rounded(cfg.adam_b2, nu.dtype)).float()
            mu.copy_(m)
            nu.copy_(v)
            u = (m / c1).div_(torch.sqrt(v / c2).add_(cfg.adam_eps))
            if cfg.weight_decay:
                u.add_(p.float(), alpha=cfg.weight_decay)
            p.copy_(p.float().add_(u, alpha=-lr))
        return {"count": count + 1, "mu": state["mu"], "nu": state["nu"]}


def make_optimizer(cfg: TrainConfig) -> AdamW:
    """AdamW over the TRAINABLE params: init with ``split_frozen(...)[0]``."""
    return AdamW(cfg)


@dataclasses.dataclass
class Batch:
    """One (accum, B, S) training window on one device; labels use -100.

    ``vision_*`` carry each micro-batch's clips concatenated (padded to a
    patch bucket); None when no sample of the window has video."""

    input_ids: torch.Tensor        # [A, B, S]
    labels: torch.Tensor           # [A, B, S]
    position_ids: torch.Tensor     # [A, 3, B, S]
    attention_mask: torch.Tensor   # [A, B, S] bool, or int32 segment ids (packed)
    vision_patches: Optional[torch.Tensor] = None   # [A, N, patch_dim]
    vision_cos: Optional[torch.Tensor] = None       # [A, N, hd]
    vision_sin: Optional[torch.Tensor] = None
    vision_seg_ids: Optional[torch.Tensor] = None   # [A, N]
    image_patches: Optional[torch.Tensor] = None    # [A, Ni, patch_dim]
    image_cos: Optional[torch.Tensor] = None
    image_sin: Optional[torch.Tensor] = None
    image_seg_ids: Optional[torch.Tensor] = None
    vision_group: Optional[int] = None
    image_group: Optional[int] = None

    @property
    def accum(self) -> int:
        return self.input_ids.shape[0]

    def micro(self, i: int) -> "Batch":
        """Micro-batch ``i`` (the leading axis dropped)."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name)[i] for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _ce_route(tcfg: TrainConfig, device: torch.device) -> tuple[str, Optional[torch.dtype]]:
    on_cuda = device.type == "cuda"
    impl = tcfg.ce_impl or (CE_IMPL if on_cuda else "scan")
    logits = tcfg.ce_logits or (CE_LOGITS if on_cuda else "f32")
    if logits not in ("bf16", "f32"):
        raise ValueError(f"ce_logits must be 'bf16' or 'f32', got {logits!r}")
    return impl, (torch.bfloat16 if logits == "bf16" else None)


def loss_fn(model: Qwen2VL, cfg: ModelConfig, tcfg: TrainConfig, micro: Batch):
    """Summed CE over the supervised tokens of one micro-batch.

    Returns ``(loss, (count, dropped))``; ``dropped`` counts supervised
    positions cut by an undersized ``ce_sup_bucket`` (0 without one)."""
    vision = vision_images = None
    if micro.vision_patches is not None:
        vision = VisionInputs(micro.vision_patches, micro.vision_cos, micro.vision_sin,
                              micro.vision_seg_ids, group=micro.vision_group)
    if micro.image_patches is not None:
        vision_images = VisionInputs(micro.image_patches, micro.image_cos, micro.image_sin,
                                     micro.image_seg_ids, group=micro.image_group)
    hidden, _ = forward(model, cfg, micro.input_ids, micro.position_ids, vision=vision,
                        vision_images=vision_images, attention_mask=micro.attention_mask,
                        compute_logits=False, remat=tcfg.remat, seq_shard=tcfg.seq_shard)
    impl, logit_dtype = _ce_route(tcfg, hidden.device)
    text = model.text
    weight = text.embed.weight if cfg.text.tie_word_embeddings else text.lm_head.weight
    kernel = weight.t()                                     # [H, V] view, never a copy
    labels = micro.labels
    # next-token shift: predict labels[t+1] from hidden[t]
    shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], IGNORE_INDEX)], dim=1)
    kernel_grad = weight.requires_grad
    if text.tp is None:
        ce = functools.partial(chunked_cross_entropy, impl=impl)
    else:           # a vocab-split head: each model rank's gradient of hidden is partial
        hidden = copy_to_model(hidden, text.tp)
        ce = functools.partial(vocab_parallel_ce, tp=text.tp, v_total=cfg.text.vocab_size)
    if tcfg.ce_sup_bucket:
        kb = tcfg.ce_sup_bucket
        b, s, h = hidden.shape
        flat_h, flat_l = hidden.reshape(b * s, h), shifted.reshape(b * s)
        sup = flat_l != IGNORE_INDEX
        n_sup = sup.sum()
        # the first kb supervised positions in order (no host sync); slots
        # past n_sup gather unsupervised rows and are masked out
        idx = torch.sort((~sup).to(torch.int32), stable=True).indices[:kb]
        if idx.shape[0] < kb:
            idx = torch.nn.functional.pad(idx, (0, kb - idx.shape[0]))
        slot = torch.arange(kb, device=idx.device)
        lab = torch.where(slot < n_sup, flat_l[idx], torch.full_like(flat_l[idx], IGNORE_INDEX))
        loss, count = ce(flat_h[idx][None], kernel, lab[None],
                         chunk_size=min(tcfg.ce_chunk_size, kb), logit_dtype=logit_dtype,
                         kernel_grad=kernel_grad)
        dropped = torch.clamp(n_sup - kb, min=0)
    else:
        loss, count = ce(hidden, kernel, shifted, chunk_size=tcfg.ce_chunk_size,
                         logit_dtype=logit_dtype, kernel_grad=kernel_grad)
        dropped = torch.zeros((), dtype=torch.int64, device=hidden.device)
    return loss, (count, dropped)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, optimizer: AdamW):
    """Returns ``step(model, opt_state, batch) -> (model, opt_state, metrics)``.

    The model's trainable parameters are updated in place. Accumulates over
    the leading ``A`` axis of the Batch, normalizing by the total supervised
    token count of the window (HF Trainer semantics). Each parameter's
    ``.grad`` is added into its fp32 accumulator and freed as autograd
    completes it (a post-accumulate-grad hook, removed after the step), so
    a backward never holds every ``.grad`` at once; JAX's ``value_and_grad``
    returns the whole tree, and the sums are the same. ``metrics`` holds
    device tensors (``loss``, ``tokens``, ``ce_dropped``): reading them syncs."""

    def take(acc: torch.Tensor):
        @torch.no_grad()
        def hook(p: torch.Tensor) -> None:
            if p.grad is not None:          # one parameter under two names: taken once
                acc.add_(p.grad)
                p.grad = None
        return hook

    def step(model: Qwen2VL, opt_state: dict, batch: Batch):
        trainable, _ = split_frozen(model, tcfg.freeze_modules)
        dev = batch.input_ids.device
        acc = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in trainable.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        count_sum = torch.zeros((), dtype=torch.int64, device=dev)
        drop_sum = torch.zeros((), dtype=torch.int64, device=dev)
        for p in trainable.values():
            p.grad = None
        hooks = [p.register_post_accumulate_grad_hook(take(acc[n]))
                 for n, p in trainable.items()]
        try:
            for i in range(batch.accum):
                loss, (count, dropped) = loss_fn(model, cfg, tcfg, batch.micro(i))
                loss.backward()
                loss_sum += loss.detach()
                count_sum += count
                drop_sum += dropped
        finally:
            for h in hooks:
                h.remove()
        denom = torch.clamp(count_sum, min=1).float()
        for g in acc.values():
            g.div_(denom)
        opt_state = optimizer.update(acc, opt_state, trainable)
        metrics = {"loss": loss_sum / denom, "tokens": count_sum, "ce_dropped": drop_sum}
        return model, opt_state, metrics

    return step


def make_mesh_train_step(cfg: ModelConfig, tcfg: TrainConfig, optimizer: AdamW, zero):
    """``make_train_step`` on a mesh: ``step(model, opt_state, batch)``
    over this rank's batch rows, ``model`` sharded by
    ``parallel/sharding.py:shard_params``, its trainable parameters the
    views of ``zero`` (a ``Zero2``), ``opt_state`` ``zero.init_state``'s.
    Every rank of the mesh calls it once a window."""
    data_group = zero.mesh.data_group
    seq_partial = [n for n in zero.names if is_sequence_partial(n)] if tcfg.seq_shard else []

    def step(model: Qwen2VL, opt_state: dict, batch: Batch):
        dev = batch.input_ids.device
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        ints = torch.zeros((2,), dtype=torch.int64, device=dev)      # count, dropped
        with zero.grad_hooks():
            for i in range(batch.accum):
                loss, (count, dropped) = loss_fn(model, cfg, tcfg, batch.micro(i))
                loss.backward()
                zero.accumulate()
                loss_sum += loss.detach()
                ints += torch.stack([count, dropped])
        zero.sum_over_model(seq_partial)
        dist.all_reduce(loss_sum, group=data_group)
        dist.all_reduce(ints, group=data_group)
        denom = torch.clamp(ints[0], min=1).float()
        opt_state = zero.update(optimizer, opt_state, denom)
        metrics = {"loss": loss_sum / denom, "tokens": ints[0], "ce_dropped": ints[1]}
        return model, opt_state, metrics

    return step

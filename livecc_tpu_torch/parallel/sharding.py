"""Which parameter is split where, and the ZeRO-2 state of one rank.

Port of ``livecc_tpu/parallel/sharding.py``. JAX states partition specs
and XLA moves the data; the port slices the weights itself and keeps the
optimizer's state in flat buffers:

  * **TP over the model axis** (``split_dim``, JAX ``param_pspecs``): the
    q / k / v and gate / up weights and the q / k / v biases split on their
    output dim, o and down on their input dim (Megatron's layout), the
    embedding and the untied lm_head on their vocab rows; the ViT and the
    norms are replicated. ``shard_params`` slices a whole model into this
    rank's shard in place; M must divide the heads, the MLP width and the
    vocabulary.
  * **ZeRO-2 over the data axis** (``Zero2``). JAX shards each optimizer
    leaf on its largest divisible dim; the port keeps DeepSpeed's layout
    instead: one flat, padded buffer of this model rank's trainable shard,
    cut into ``n_data`` equal partitions, AdamW's moments only for its own.
    AdamW is elementwise, so both layouts compute the same numbers. The
    parameters become views of the flat buffer (so the update's all-gather
    writes them in place), and the fp32 gradient accumulator is one flat
    buffer of the same layout, reduce-scattered in place into the
    partition: no second full-size copy of the gradient exists.

``gather_state`` / ``load_state`` convert to and from the single-card
``state.pt`` format (``train/trainer.py``) tensor by tensor, so a
checkpoint taken on one mesh restores on any other, or on one card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.core.mesh import Mesh
from livecc_tpu_torch.ops.quant import QuantEmbedding, QuantLinear
from livecc_tpu_torch.parallel.tp import TensorParallel
from livecc_tpu_torch.parallel.tp import all_gather_flat as _all_gather_flat
from livecc_tpu_torch.parallel.tp import reduce_scatter_flat as _reduce_scatter_flat

# elements of the partition one AdamW call updates: bounds its fp32 temporaries to ~256 MB
ADAM_CHUNK = 1 << 26

# decoder-layer tensor -> the dim of the port's [out, in] weight split over
# the model axis; an int8 module's codes ``q`` split as its weight, its
# per-output ``scale`` with the output (q / k / v, gate / up) or not at all
# (o, down: JAX replicates it)
_COLUMN, _ROW = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"), ("o_proj", "down_proj")
_LAYER_SPLIT = {
    **{f"{m}.{leaf}": 0 for m in _COLUMN for leaf in ("weight", "bias", "q", "scale")},
    **{f"{m}.{leaf}": 1 for m in _ROW for leaf in ("weight", "q")},
}
_VOCAB = {f"text.{m}.{leaf}" for m in ("embed", "lm_head") for leaf in ("weight", "q", "scale")}


def split_dim(name: str) -> Optional[int]:
    """The dim of parameter or int8 buffer ``name`` (the port's names) that
    the model axis splits, or None where it is replicated."""
    if name.startswith("visual."):
        return None
    if name in _VOCAB:
        return 0                                    # vocab rows (and their scales)
    if name.startswith("text.layers."):
        return _LAYER_SPLIT.get(name.split(".", 3)[3])
    return None                                     # norms


def is_sequence_partial(name: str) -> bool:
    """Whether parameter ``name``'s gradient on a model rank is only its
    sequence block's part under sequence parallelism: the decoder layers'
    norms, which run on the block (the final norm runs on the gathered
    sequence)."""
    return name.startswith("text.layers.") and name.endswith(("input_ln.weight",
                                                              "post_ln.weight"))


def shard_size(n: int, parts: int) -> int:
    return -(-n // parts)


def local_slice(full: torch.Tensor, dim: Optional[int], m: int, m_size: int) -> torch.Tensor:
    """Rank ``m``'s part of ``full`` along ``dim`` (``check_tp`` has made
    sure that ``m_size`` divides it)."""
    if dim is None or m_size == 1:
        return full
    return full.chunk(m_size, dim=dim)[m]


def check_tp(cfg: ModelConfig, model: nn.Module, m_size: int, training: bool = False) -> None:
    """Raise where the model cannot be split over ``m_size`` model ranks,
    or where a model for ``training`` holds int8 weights."""
    t = cfg.text
    quantized = [n for n, mod in model.named_modules()
                 if isinstance(mod, (QuantLinear, QuantEmbedding))]
    if quantized and training:
        raise NotImplementedError(f"int8 weights do not train ({quantized[0]}, ...; build the "
                                  f"model without quantize_weights)")
    for what, n in (("num_key_value_heads", t.num_key_value_heads),
                    ("num_attention_heads", t.num_attention_heads),
                    ("intermediate_size", t.intermediate_size),
                    ("vocab_size", t.vocab_size)):
        if n % m_size:
            raise ValueError(f"the model axis M = {m_size} must divide {what} = {n}")


@torch.no_grad()
def shard_params(model: nn.Module, cfg: ModelConfig, mesh: Mesh, training: bool = False) -> None:
    """Slice ``model``'s split parameters and int8 buffers to this rank's
    shard, in place, and give the text tower and its layers the model
    group (which switches on their collectives, ``parallel/tp.py``). Each
    split tensor gets storage of its shard's size: a chunk on dim 0 is a
    view of the whole tensor, which would keep the whole storage alive, so
    every shard is cloned and the whole tensor dropped. An int8 model
    (``ops/quant.py:quantize_model``) is quantized whole before it is
    sharded, as JAX does; ``training`` refuses one."""
    check_tp(cfg, model, mesh.n_model, training)
    if mesh.n_model > 1:
        for name, mod in model.named_modules():
            for leaf, t in [*mod._parameters.items(), *mod._buffers.items()]:
                dim = None if t is None else split_dim(f"{name}.{leaf}")
                if dim is None:
                    continue
                part = local_slice(t.data, dim, mesh.m, mesh.n_model).clone(
                    memory_format=torch.contiguous_format)
                if leaf in mod._parameters:
                    t.data = part
                else:
                    mod._buffers[leaf] = part
    tp = TensorParallel(mesh.model_group, mesh.m, mesh.n_model)
    model.text.tp = tp
    for layer in model.text.layers:
        layer.tp = tp


def gather_model(local: torch.Tensor, name: str, mesh: Mesh) -> torch.Tensor:
    """The whole of a model-split tensor from every model rank's shard
    (on this rank's device; the replicated ones as they are)."""
    dim = split_dim(name)
    if dim is None or mesh.n_model == 1:
        return local
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.n_model)]
    dist.all_gather(parts, local, group=mesh.model_group)
    return torch.cat(parts, dim=dim)


class Zero2:
    """This rank's flat ZeRO-2 state over ``params`` (the trainable shard,
    ``{name: parameter}``): the replicated parameters first, then the split
    ones, each in model order, padded to a multiple of ``n_data``;
    partition ``d`` is ``[d * P, (d + 1) * P)``. ``grad`` is the fp32
    accumulator in the same layout, ``views`` its per-parameter views.
    ``split(name)`` is None for a parameter every model rank holds alike
    (TP's ``split_dim``; pipeline parallelism's ``pipeline.pp_split``)."""

    def __init__(self, params: dict[str, nn.Parameter], mesh: Mesh, split=split_dim):
        dtypes = {p.dtype for p in params.values()}
        if len(dtypes) != 1:
            raise ValueError(f"ZeRO-2: the trainable parameters mix dtypes {dtypes}")
        self.mesh = mesh
        names = sorted(params, key=lambda n: split(n) is not None)      # stable: model order
        self.names = names
        self.replicated = sum(params[n].numel() for n in names if split(n) is None)
        n = sum(p.numel() for p in params.values())
        self.part = shard_size(n, mesh.n_data)
        dev = next(iter(params.values())).device
        self.flat = torch.zeros(self.part * mesh.n_data, dtype=dtypes.pop(), device=dev)
        self.grad = torch.zeros(self.flat.shape, dtype=torch.float32, device=dev)
        self.offsets, self.params, self.views = {}, {}, {}
        at = 0
        with torch.no_grad():
            for name in names:
                p = params[name]
                k = p.numel()
                self.flat[at:at + k].copy_(p.data.reshape(-1))
                p.data = self.flat[at:at + k].view_as(p)
                self.views[name] = self.grad[at:at + k].view_as(p)
                self.offsets[name], self.params[name] = at, p
                at += k
        self.lo = mesh.d * self.part

    def init_state(self, mu_dtype: Optional[torch.dtype]) -> dict:
        """AdamW's state over this rank's partition: ``{"count", "mu": [P],
        "nu": [P]}`` (mu in ``mu_dtype``, fp32 by default; nu fp32)."""
        dev = self.flat.device
        return {"count": 0,
                "mu": torch.zeros(self.part, dtype=mu_dtype or torch.float32, device=dev),
                "nu": torch.zeros(self.part, dtype=torch.float32, device=dev)}

    def accumulate(self) -> None:
        """Add each parameter's ``.grad`` into the fp32 accumulator and drop it."""
        for name, p in self.params.items():
            if p.grad is not None:
                self.views[name].add_(p.grad)
                p.grad = None

    def sum_over_model(self, names) -> None:
        """Sum the accumulated gradients of ``names`` over the model group,
        in place: one all-reduce for each run of adjacent parameters in the
        flat buffer (for parameters whose model ranks each hold a part of
        the gradient)."""
        if self.mesh.n_model == 1:
            return
        runs: list[list[int]] = []
        for lo, n in sorted((self.offsets[n], self.params[n].numel()) for n in names):
            if runs and runs[-1][1] == lo:
                runs[-1][1] = lo + n
            else:
                runs.append([lo, lo + n])
        for lo, hi in runs:
            dist.all_reduce(self.grad[lo:hi], group=self.mesh.model_group)

    def global_norm(self, g: torch.Tensor) -> torch.Tensor:
        """The norm of the whole logical gradient from this partition's
        ``g``: every split element once (the model ranks hold different
        ones), every replicated one once (only model rank 0 counts them)."""
        cut = min(max(self.replicated - self.lo, 0), self.part)
        sq = torch.linalg.vector_norm(g[cut:]).square()
        if self.mesh.m == 0:
            sq = sq + torch.linalg.vector_norm(g[:cut]).square()
        dist.all_reduce(sq)
        return sq.sqrt()

    @torch.no_grad()
    def update(self, optimizer, state: dict, denom: torch.Tensor) -> dict:
        """Reduce-scatter the window's gradient sum over the data group,
        divide it by the global supervised count ``denom``, clip by the
        global norm, run AdamW on this partition and all-gather the updated
        parameters; the accumulator is zeroed for the next window. Both
        collectives work in place (this rank's partition is the view of
        the flat buffers at its offset, as NCCL's in-place forms take it),
        and AdamW runs ``ADAM_CHUNK`` elements at a time, so no buffer of
        the partition's size is made."""
        mesh = self.mesh
        g = self.grad[self.lo:self.lo + self.part]
        _reduce_scatter_flat(g, self.grad, group=mesh.data_group)
        g.div_(denom)
        norm = self.global_norm(g)
        mine = self.flat[self.lo:self.lo + self.part]
        count, mu, nu = state["count"], state["mu"], state["nu"]
        for a in range(0, self.part, ADAM_CHUNK):
            b = a + ADAM_CHUNK
            optimizer.update({"flat": g[a:b]}, {"count": count, "mu": {"flat": mu[a:b]},
                                                "nu": {"flat": nu[a:b]}},
                             {"flat": mine[a:b]}, g_norm=norm)
        _all_gather_flat(self.flat, mine, group=mesh.data_group)
        self.grad.zero_()
        return {"count": count + 1, "mu": mu, "nu": nu}

    def _overlap(self, name: str) -> tuple[int, int, int]:
        """(start in the parameter, start in the partition, length) of the
        part of ``name``'s flat range that this rank's partition holds."""
        at, k = self.offsets[name], self.params[name].numel()
        lo = max(at, self.lo)
        hi = min(at + k, self.lo + self.part)
        return lo - at, lo - self.lo, max(hi - lo, 0)

    def gather_moment(self, part: torch.Tensor, name: str) -> torch.Tensor:
        """A moment of parameter ``name`` in its model-rank shape, assembled
        over the data group from the partitions that hold pieces of it."""
        p = self.params[name]
        buf = torch.zeros(p.numel(), dtype=part.dtype, device=part.device)
        src, dst, n = self._overlap(name)
        buf[src:src + n] = part[dst:dst + n]
        dist.all_reduce(buf, group=self.mesh.data_group)
        return buf.view_as(p)

    def load_moment(self, part: torch.Tensor, name: str, local: torch.Tensor) -> None:
        """Write this partition's piece of ``local`` (parameter ``name``'s
        moment in its model-rank shape) into ``part``."""
        src, dst, n = self._overlap(name)
        part[dst:dst + n] = local.reshape(-1)[src:src + n].to(part.device, part.dtype)


def gather_state(model: nn.Module, zero: Zero2, opt_state: dict, step: int) -> Optional[dict]:
    """The single-card ``state.pt`` dict, assembled tensor by tensor in rank
    0's host memory (every rank takes part; the others get None)."""
    mesh = zero.mesh
    host = mesh.rank == 0

    def keep(t):
        return t.detach().cpu() if host else None

    params = {name: keep(gather_model(t, name, mesh))
              for name, t in model.state_dict().items()}
    moments = {}
    for key in ("mu", "nu"):
        moments[key] = {
            name: keep(gather_model(zero.gather_moment(opt_state[key], name), name, mesh))
            for name in zero.names}
    if not host:
        return None
    return {"params": params, "opt_state": {"count": opt_state["count"], **moments},
            "step": step}


@torch.no_grad()
def load_state(model: nn.Module, zero: Zero2, opt_state: dict, state: dict) -> None:
    """Slice a single-card ``state.pt`` dict (whole tensors, e.g. mapped from
    disk) into this rank's parameters and moment partitions."""
    mesh = zero.mesh
    for name, t in model.state_dict().items():
        t.copy_(local_slice(state["params"][name], split_dim(name), mesh.m, mesh.n_model))
    for key in ("mu", "nu"):
        for name in zero.names:
            local = local_slice(state["opt_state"][key][name], split_dim(name), mesh.m,
                                mesh.n_model)
            zero.load_moment(opt_state[key], name, local)
    opt_state["count"] = state["opt_state"]["count"]

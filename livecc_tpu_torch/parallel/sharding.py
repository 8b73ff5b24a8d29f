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
    leaf on its largest divisible dim; the port keeps DeepSpeed's stage-2
    layout instead: one flat, padded buffer of this model rank's trainable
    shard, cut into ``n_data`` equal partitions, and for its own partition
    only the fp32 gradient and AdamW's moments. AdamW is elementwise, so
    both layouts compute the same numbers. The parameters become views of
    the flat buffer (so the update's all-gather writes them in place). The
    gradient leaves each bf16 ``.grad`` during the backward, as autograd
    completes it, through fixed buckets reduced to their partition's owner
    (``Zero2.grad_hooks``), so no whole-size gradient exists.

``gather_state`` / ``load_state`` convert to and from the single-card
``state.pt`` format (``train/trainer.py``) tensor by tensor, so a
checkpoint taken on one mesh restores on any other, or on one card.
"""

from __future__ import annotations

import contextlib
import zlib
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.core.mesh import Mesh
from livecc_tpu_torch.ops.quant import QuantEmbedding, QuantLinear
from livecc_tpu_torch.parallel.tp import TensorParallel
from livecc_tpu_torch.parallel.tp import all_gather_flat as _all_gather_flat

# elements of the partition one AdamW call updates: bounds its fp32 temporaries to ~256 MB
ADAM_CHUNK = 1 << 26
# fp32 elements of the staging bucket a data rank reduces its gradients
# through (128 MiB; the memory plan counts it)
GRAD_BUCKET = 1 << 25

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


def grad_bucket_elements(part: int, n_data: int) -> int:
    """Elements of ``Zero2``'s fp32 staging bucket over data partitions of
    ``part`` elements: none at ``n_data == 1``, else at most ``GRAD_BUCKET``
    (read at the call, so a test can set a smaller one)."""
    return 0 if n_data == 1 else min(GRAD_BUCKET, part)


class Zero2:
    """This rank's flat ZeRO-2 state over ``params`` (the trainable shard,
    ``{name: parameter}``): the replicated parameters first, then the split
    ones, each in model order, padded to a multiple of ``n_data``;
    partition ``d`` is ``[d * P, (d + 1) * P)``, and ``grad`` is the fp32
    gradient of this rank's partition only (``[P]``, flat positions
    ``[lo, lo + P)``). ``split(name)`` is None for a parameter every model
    rank holds alike (TP's ``split_dim``; pipeline parallelism's
    ``pipeline.pp_split``).

    A step runs its backwards inside ``grad_hooks()``: as autograd
    completes a parameter's ``.grad``, a hook takes it and frees it. At
    ``n_data == 1`` the hook adds it into the partition (the whole flat
    buffer). Otherwise the flat buffer is cut into fixed buckets, each
    partition into runs of at most ``grad_bucket_elements`` positions, taken
    last position first (roughly autograd's order: the last layers'
    gradients come first). The hook holds the ``.grad`` until every
    parameter of the next bucket has one, then stages that bucket in fp32
    (``bucket``), ``dist.reduce``s it to the partition's owner, which adds
    it into ``grad``, and frees the ``.grad``s it finished. ``accumulate()``
    after each backward reduces the buckets left, with zeros for a
    parameter that got no gradient on this rank (a ViT that this rank's
    rows did not run). So every data rank reduces the same buckets in the
    same order whichever gradients its rows produced (DDP's
    ``find_unused_parameters``, with one staging buffer)."""

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
        self.lo = mesh.d * self.part
        dev = next(iter(params.values())).device
        self.flat = torch.zeros(self.part * mesh.n_data, dtype=dtypes.pop(), device=dev)
        self.grad = torch.zeros(self.part, dtype=torch.float32, device=dev)
        size = grad_bucket_elements(self.part, mesh.n_data)
        self.bucket = torch.zeros(size, dtype=torch.float32, device=dev)
        self.offsets, self.params = {}, {}
        at = 0
        with torch.no_grad():
            for name in names:
                p = params[name]
                k = p.numel()
                self.flat[at:at + k].copy_(p.data.reshape(-1))
                p.data = self.flat[at:at + k].view_as(p)
                self.offsets[name], self.params[name] = at, p
                at += k
        # (start, end, owner, members): each partition's runs, last first;
        # a run of padding only has no members and is never reduced
        self.buckets: list[tuple[int, int, int, list[str]]] = []
        for d in reversed(range(mesh.n_data if size else 0)):
            for a in reversed(range(d * self.part, (d + 1) * self.part, size)):
                b = min(a + size, (d + 1) * self.part)
                members = [k for k in names
                           if self.offsets[k] < b and self.offsets[k] + params[k].numel() > a]
                if members:
                    self.buckets.append((a, b, d, members))
        self._round: Optional[list[int]] = None     # the buckets grad_hooks' backwards reduce
        self._names: frozenset = frozenset()        # the parameters they give gradients to
        self._first: dict[str, int] = {}            # name -> its first and last place in _round
        self._last: dict[str, int] = {}
        self._next = 0                              # the next place in _round to reduce
        self._held: dict[str, torch.Tensor] = {}    # bf16 gradients awaiting their buckets
        if mesh.n_model > 1 and mesh.model_group is not None:   # no group: a planning stand-in
            self._check_model_layout(split)

    def _check_model_layout(self, split) -> None:
        """Raise unless every model rank at this data index has the flat
        size and the replicated parameters' names, offsets and sizes of
        this one: ``sum_over_model`` sums partitions over the model group,
        which is the sum of the gradients only where those agree."""
        head = ";".join(f"{n}:{self.offsets[n]}:{self.params[n].numel()}"
                        for n in self.names if split(n) is None)
        mine = torch.tensor([self.flat.numel(), zlib.crc32(head.encode())], dtype=torch.int64,
                            device=self.flat.device)
        every = [torch.empty_like(mine) for _ in range(self.mesh.n_model)]
        dist.all_gather(every, mine, group=self.mesh.model_group)
        if any(not torch.equal(x, mine) for x in every):
            raise ValueError(f"ZeRO-2: the model ranks' flat layouts differ ({every}): the "
                             f"replicated parameters must lead in one order and every rank "
                             f"hold the same flat size")

    def init_state(self, mu_dtype: Optional[torch.dtype]) -> dict:
        """AdamW's state over this rank's partition: ``{"count", "mu": [P],
        "nu": [P]}`` (mu in ``mu_dtype``, fp32 by default; nu fp32)."""
        dev = self.flat.device
        return {"count": 0,
                "mu": torch.zeros(self.part, dtype=mu_dtype or torch.float32, device=dev),
                "nu": torch.zeros(self.part, dtype=torch.float32, device=dev)}

    @contextlib.contextmanager
    def grad_hooks(self, names=None):
        """Hooks on the parameters, for the duration of the block, that take
        each ``.grad`` into the partition as autograd completes it and free
        it. ``names`` are the parameters the block's backwards may give
        gradients to (all by default; pipeline stages name their CE's and
        their layers'): the buckets that hold them are reduced after every
        backward, so the set must be the same on every data rank, and a
        gradient outside it raises. A step enters this around its
        backwards; outside it the parameters' gradients are left to their
        callers."""
        want = frozenset(self.names if names is None else names)
        self._names, self._first, self._last = want, {}, {}
        self._round = [i for i, (_, _, _, members) in enumerate(self.buckets)
                       if want.intersection(members)]
        for place, i in enumerate(self._round):
            for name in self.buckets[i][3]:
                self._first.setdefault(name, place)
                self._last[name] = place
        for p in self.params.values():
            p.grad = None
        handles = [p.register_post_accumulate_grad_hook(self._take(name))
                   for name, p in self.params.items()]
        try:
            yield
        finally:
            for h in handles:
                h.remove()
            self._round = None

    def _take(self, name: str):
        at = self.offsets[name]

        @torch.no_grad()
        def hook(p: torch.Tensor) -> None:
            g = p.grad.reshape(-1)
            p.grad = None
            if name not in self._names:
                raise RuntimeError(f"ZeRO-2: a gradient for {name}, outside the parameters "
                                   f"this step's grad_hooks named")
            if self.mesh.n_data == 1:
                self.grad[at:at + g.numel()].add_(g)
                return
            if self._next > self._first[name]:
                raise RuntimeError(f"ZeRO-2: a second gradient for {name} in one backward, "
                                   f"after part of it was reduced")
            held = self._held.get(name)
            self._held[name] = g if held is None else held.add_(g)
            while self._next < len(self._round) and all(
                    k in self._held for k in self.buckets[self._round[self._next]][3]):
                self._reduce_next()

        return hook

    def _reduce_next(self) -> None:
        """Stage the next bucket of the round in fp32 (zeros where a member
        has no gradient), reduce it to its partition's owner, which adds it
        into ``grad``, and free the gradients it finished."""
        place = self._next
        a, b, owner, members = self.buckets[self._round[place]]
        mesh, buf = self.mesh, self.bucket[:b - a]
        buf.zero_()
        for name in members:
            g = self._held.get(name)
            if g is None:
                continue
            at = self.offsets[name]
            lo, hi = max(a, at), min(b, at + g.numel())
            buf[lo - a:hi - a].copy_(g[lo - at:hi - at])
            if self._last[name] == place:
                del self._held[name]
        dist.reduce(buf, dst=owner * mesh.n_model + mesh.m, group=mesh.data_group)
        if owner == mesh.d:
            self.grad[a - self.lo:b - self.lo].add_(buf)
        self._next = place + 1

    def accumulate(self) -> None:
        """End a backward: reduce the round's buckets the hooks have not
        (the hooks have taken every ``.grad``; a parameter that got none
        counts as zeros)."""
        if self.mesh.n_data == 1:
            return
        if self._round is None:
            raise RuntimeError("ZeRO-2: accumulate() outside grad_hooks()")
        while self._next < len(self._round):
            self._reduce_next()
        self._next = 0

    def _partition_runs(self, names) -> list[tuple[int, int]]:
        """The partition's ``[lo, hi)`` ranges that hold ``names``' elements,
        adjacent parameters merged."""
        runs: list[list[int]] = []
        for at, n in sorted((self.offsets[n], self.params[n].numel()) for n in names):
            lo, hi = max(at, self.lo) - self.lo, min(at + n, self.lo + self.part) - self.lo
            if hi <= lo:
                continue
            if runs and runs[-1][1] == lo:
                runs[-1][1] = hi
            else:
                runs.append([lo, hi])
        return [(lo, hi) for lo, hi in runs]

    def sum_over_model(self, names) -> None:
        """Sum the partition's gradients of ``names`` over the model group,
        in place: one all-reduce for each run of adjacent parameters (for
        parameters whose model ranks each hold a part of the gradient).
        The model ranks at one data index hold the same flat positions
        (checked at construction), so this commutes with the data
        group's reduction."""
        if self.mesh.n_model == 1:
            return
        for lo, hi in self._partition_runs(names):
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
        """Divide the window's gradient sum (already this partition's, over
        the data group) by the global supervised count ``denom``, clip by
        the global norm, run AdamW on this partition and all-gather the
        updated parameters; the partition is zeroed for the next window.
        The all-gather works in place (this rank's partition is the view of
        the flat buffer at its offset, as NCCL's in-place form takes it),
        and AdamW runs ``ADAM_CHUNK`` elements at a time, so no buffer of
        the partition's size is made."""
        mesh = self.mesh
        if self._next or self._held:
            raise RuntimeError("ZeRO-2: update with gradients not yet reduced (call "
                               "accumulate() after each backward)")
        g = self.grad
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

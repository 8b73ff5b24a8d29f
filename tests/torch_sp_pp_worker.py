"""One rank of the multi-process cases of ``tests/test_torch_seq_shard.py``
and ``tests/test_torch_pipeline.py``.

    python tests/torch_sp_pp_worker.py RANK WORLD N_DATA N_MODEL IO_DIR

The ranks meet over gloo at ``file://IO_DIR/rendezvous``. ``IO_DIR/args.pkl``
holds a list of cases, run in turn; each case is a dict of numpy arrays,
lists and numbers (nothing that needs JAX to unpickle). Every rank writes
its results to ``IO_DIR/out<RANK>.pt`` as a list with one entry a case.
Imports torch and the port only, and checks at the end that JAX was never
imported.

Kinds of case:

  * ``sp``: ``windows`` steps of ``make_mesh_train_step`` on a model split
    by ``shard_params``, with ``seq_shard`` on and then off (the port's TP
    step on the same inputs), from the same weights; the gathered state
    after each, the replicated parameters' agreement across the model
    ranks, the all-gathers / reduce-scatters each run issued and every
    rank's ZeRO-2 facts (``torch_mesh_worker.zero_facts``).
    ``exit_doubled`` reduce-scatters the gradient at the tower's exit (a
    planted fault: it multiplies that gradient by M).
  * ``pp``: ``windows`` steps of ``make_pp_train_step`` on a model cut by
    ``shard_params_pp``; this stage's parameters and AdamW moments, the
    point-to-point calls it issued and every rank's ZeRO-2 facts.

``bucket`` sets ``parallel/sharding.py``'s ``GRAD_BUCKET`` for the case
(``Zero2``'s staging bucket and the plan's count of it).

A case's batch is either ``samples`` (processed samples, collated into
micro-step a's row d = ``samples[a * n_data + d]``) or ``batch`` (whole
arrays ``[A, n_data * B, S]``, of which data rank d takes rows
``[d B, (d + 1) B)``, as JAX's data sharding lays them out).
"""

import collections
import dataclasses
import os
import pickle
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from livecc_tpu_torch.core.config import tiny_config  # noqa: E402
from livecc_tpu_torch.core.mesh import make_mesh  # noqa: E402
from livecc_tpu_torch.models.qwen2_vl.bridge import params_from_jax  # noqa: E402
from livecc_tpu_torch.parallel import tp as ptp  # noqa: E402
from livecc_tpu_torch.parallel.pipeline import (  # noqa: E402
    make_pp_train_step, pp_split, shard_params_pp)
from livecc_tpu_torch.parallel import sharding  # noqa: E402
from livecc_tpu_torch.parallel.sharding import (  # noqa: E402
    Zero2, gather_state, shard_params, split_dim)
from livecc_tpu_torch.train import data as pdata  # noqa: E402
from livecc_tpu_torch.train import step as pstep  # noqa: E402
from torch_mesh_worker import Reductions, plan_for, watch, zero_facts  # noqa: E402

GRAD_BUCKET = sharding.GRAD_BUCKET

# op -> the torch function the port calls for it (``parallel/tp.py``'s flat
# collectives take torch's newer name where it has one)
COUNTED = {"all_gather": "all_gather_single" if hasattr(dist, "all_gather_single")
           else "all_gather_into_tensor",
           "reduce_scatter": "reduce_scatter_single" if hasattr(dist, "reduce_scatter_single")
           else "reduce_scatter_tensor",
           "send": "send", "recv": "recv"}


def config(case):
    cfg = tiny_config()
    text = dataclasses.replace(cfg.text, num_hidden_layers=case.get("layers", 2),
                               tie_word_embeddings=case.get("tied", False))
    return dataclasses.replace(cfg, text=text)


def batch_of(case, cfg, mesh):
    if "samples" in case:
        return pdata.collate(case["samples"][mesh.d::mesh.n_data], cfg, device="cpu")
    arrays = case["batch"]
    rows = arrays["input_ids"].shape[1] // mesh.n_data
    own = slice(mesh.d * rows, (mesh.d + 1) * rows)
    return pstep.Batch(
        input_ids=torch.from_numpy(arrays["input_ids"][:, own]).long(),
        labels=torch.from_numpy(arrays["labels"][:, own]).long(),
        position_ids=torch.from_numpy(arrays["position_ids"][:, :, own]).long(),
        attention_mask=torch.from_numpy(arrays["attention_mask"][:, own]))


@dataclasses.dataclass
class Counted:
    """Calls of the ops in ``COUNTED``, while on."""

    calls: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    def __enter__(self):
        self.saved = {name: getattr(dist, name) for name in COUNTED.values()}
        for op, name in COUNTED.items():
            def run(*a, _fn=self.saved[name], _op=op, **kw):
                self.calls[_op] += 1
                return _fn(*a, **kw)
            setattr(dist, name, run)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)


def doubled_exit(ctx, grad):
    """The exit's backward as a reduce-scatter (the planted fault)."""
    return ptp._reduce_scatter_seq(grad, ctx.tp), None


def sp_run(case, mesh, seq_shard):
    cfg = config(case)
    model = params_from_jax(case["params"], cfg)
    tcfg = pstep.TrainConfig(**case["tcfg"], seq_shard=seq_shard)
    batch = batch_of(case, cfg, mesh)
    shard_params(model, cfg, mesh, training=True)
    zero = Zero2(pstep.split_frozen(model, tcfg.freeze_modules)[0], mesh)
    state = zero.init_state(tcfg.adam_mu_dtype)
    step = pstep.make_mesh_train_step(cfg, tcfg, pstep.make_optimizer(tcfg), zero)
    left = watch(zero)
    metrics = []
    real = ptp._GatherSequenceExit.backward
    if case.get("exit_doubled") and seq_shard:
        ptp._GatherSequenceExit.backward = staticmethod(doubled_exit)
    try:
        with Counted() as counted, Reductions() as reduces:
            for _ in range(case["windows"]):
                model, state, m = step(model, state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
    finally:
        ptp._GatherSequenceExit.backward = real
    in_sync = True
    for name, p in model.named_parameters():
        if split_dim(name) is None:
            parts = [torch.empty_like(p) for _ in range(mesh.n_model)]
            dist.all_gather(parts, p.detach(), group=mesh.model_group)
            in_sync &= all(torch.equal(parts[0], x) for x in parts)
    plan = plan_for(cfg, mesh, tcfg, zero)
    return {"metrics": metrics, "state": gather_state(model, zero, state, case["windows"]),
            "replicated_in_sync": in_sync, "calls": dict(counted.calls),
            "micro_steps": batch.accum * case["windows"],
            "zero": zero_facts(model, zero, plan, left, reduces.calls)}


def case_sp(case, mesh):
    return {"sp": sp_run(case, mesh, True), "tp": sp_run(case, mesh, False)}


def case_pp(case, mesh):
    cfg = config(case)
    model = params_from_jax(case["params"], cfg)
    tcfg = pstep.TrainConfig(**case["tcfg"])
    batch = batch_of(case, cfg, mesh)
    shard_params_pp(model, cfg, mesh)
    zero = Zero2(pstep.split_frozen(model, tcfg.freeze_modules)[0], mesh, split=pp_split)
    state = zero.init_state(tcfg.adam_mu_dtype)
    step = make_pp_train_step(cfg, tcfg, pstep.make_optimizer(tcfg), mesh, zero)
    left = watch(zero)
    metrics = []
    with Counted() as counted:
        for _ in range(case["windows"]):
            model, state, m = step(model, state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = {key: {n: zero.gather_moment(state[key], n) for n in zero.names}
               for key in ("mu", "nu")}
    plan = plan_for(cfg, mesh, tcfg, zero, pipeline=True)
    return {"metrics": metrics, "params": params, "moments": moments, "stage": mesh.m,
            "data": mesh.d, "calls": dict(counted.calls),
            "accum": batch.accum,
            "zero": zero_facts(model, zero, plan, left, 0)}


def main():
    rank, world, n_data, n_model, io_dir = sys.argv[1:6]
    rank, world, n_data, n_model = (int(x) for x in (rank, world, n_data, n_model))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(io_dir, 'rendezvous')}",
                            rank=rank, world_size=world)
    mesh = make_mesh(n_data, n_model, "cpu")
    with open(os.path.join(io_dir, "args.pkl"), "rb") as f:
        cases = pickle.load(f)
    kinds = {"sp": case_sp, "pp": case_pp}
    out = []
    for case in cases:
        sharding.GRAD_BUCKET = case.get("bucket", GRAD_BUCKET)
        out.append(kinds[case["kind"]](case, mesh))
    dist.barrier()
    dist.destroy_process_group()
    if "jax" in sys.modules:
        raise SystemExit("torch_sp_pp_worker: jax was imported")
    torch.save(out, os.path.join(io_dir, f"out{rank}.pt"))


if __name__ == "__main__":
    main()

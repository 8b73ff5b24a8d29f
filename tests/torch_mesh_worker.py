"""One rank of a multi-process case of ``tests/test_torch_mesh.py``.

    python tests/torch_mesh_worker.py CASE RANK WORLD N_DATA N_MODEL IO_DIR

The ranks meet over gloo at ``file://IO_DIR/rendezvous`` (the test
workers share the host, so no port is claimed). ``IO_DIR/args.pkl`` holds
the case's inputs (numpy arrays, lists, dicts: nothing that needs JAX to
unpickle); rank 0 writes the results to ``IO_DIR/out.pt``. Imports torch
and the port only, and checks at the end that JAX was never imported.

Cases: ``ce`` (``vocab_parallel_ce`` and its gradients), ``step`` (the mesh
step over windows of collated samples, then the gathered state, every
rank's ZeRO-2 facts (``zero_facts``), with ``plant`` the same run again
with one bucket's reduction skipped, and under ``also`` a run for each
dict of overriding arguments) and ``trainer``
(``Trainer(mesh=)`` over an in-memory dataset). ``bucket`` sets
``parallel/sharding.py``'s ``GRAD_BUCKET`` in the rank (``Zero2``'s
staging bucket and the plan's count of it).
"""

import os
import pickle
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from livecc_tpu_torch.core.config import tiny_config  # noqa: E402
from livecc_tpu_torch.core.mesh import make_mesh  # noqa: E402
from livecc_tpu_torch.models.qwen2_vl.bridge import params_from_jax  # noqa: E402
from livecc_tpu_torch.ops.chunked_ce import vocab_parallel_ce  # noqa: E402
from livecc_tpu_torch.parallel import sharding  # noqa: E402
from livecc_tpu_torch.parallel.memory import training_plan  # noqa: E402
from livecc_tpu_torch.parallel.sharding import (  # noqa: E402
    Zero2, gather_state, shard_params, split_dim)
from livecc_tpu_torch.parallel.tp import TensorParallel, copy_to_model  # noqa: E402
from livecc_tpu_torch.train import data as pdata  # noqa: E402
from livecc_tpu_torch.train import step as pstep  # noqa: E402
from livecc_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def case_ce(mesh, args):
    tp = TensorParallel(mesh.model_group, mesh.m, mesh.n_model)
    kernel = torch.from_numpy(args["kernel"])                       # [H, V]
    v_total = kernel.shape[1]
    v_shard = -(-v_total // mesh.n_model)
    padded = torch.nn.functional.pad(kernel, (0, v_shard * mesh.n_model - v_total))
    shard = padded[:, mesh.m * v_shard:(mesh.m + 1) * v_shard].clone().requires_grad_()
    hidden = torch.from_numpy(args["hidden"]).requires_grad_()
    labels = torch.from_numpy(args["labels"])
    loss, count = vocab_parallel_ce(copy_to_model(hidden, tp), shard, labels, tp=tp,
                                    v_total=v_total, chunk_size=args["chunk_size"])
    (loss / torch.clamp(count, min=1)).backward()
    parts = [torch.empty_like(shard.grad) for _ in range(mesh.n_model)]
    dist.all_gather(parts, shard.grad.contiguous(), group=mesh.model_group)
    return {"loss": loss.detach(), "count": count, "d_hidden": hidden.grad,
            "d_kernel": torch.cat(parts, dim=1)}


def model_from(args):
    cfg = tiny_config()
    return cfg, params_from_jax(args["params"], cfg)


class Reductions:
    """Counts ``dist.reduce`` calls while on (ZeRO-2's bucket runs); with
    ``skip``, the first call does nothing on every rank (the planted
    fault: that bucket run keeps each rank's own gradient)."""

    def __init__(self, skip: bool = False):
        self.skip, self.calls = skip, 0

    def __enter__(self):
        self.real = dist.reduce

        def reduce(*a, **kw):
            self.calls += 1
            if self.skip and self.calls == 1:
                return None
            return self.real(*a, **kw)

        dist.reduce = reduce
        return self

    def __exit__(self, *exc):
        dist.reduce = self.real


def watch(zero) -> list:
    """Record, at each ``zero.accumulate()`` (right after a backward), how
    many trainable parameters still hold a ``.grad``."""
    left, real = [], zero.accumulate

    def accumulate():
        left.append(sum(p.grad is not None for p in zero.params.values()))
        real()

    zero.accumulate = accumulate
    return left


def plan_for(cfg, mesh, tcfg, zero, pipeline: bool = False):
    """``training_plan`` for this rank's mesh, trainable modules and
    parameter dtype."""
    return training_plan(cfg, n_data=mesh.n_data, n_model=mesh.n_model, hbm_gib=80.0,
                         freeze_modules=tcfg.freeze_modules,
                         param_dtype_bytes=zero.flat.element_size(), pipeline=pipeline)


def zero_facts(model, zero, plan, left: list, reduces: int) -> list:
    """Every rank's ZeRO-2 facts (gathered to all): its partition's and
    bucket's elements, the fp32 gradient bytes and the parameter bytes
    (frozen ones and the flat buffer) it holds beside the plan's, the
    ``.grad``s left after each backward, the parameters still carrying a
    post-accumulate hook after the steps, and its bucket reductions."""
    frozen = sum(p.nbytes for n, p in model.named_parameters() if n not in zero.params)
    mine = {"rank": dist.get_rank(), "grad_numel": zero.grad.numel(), "part": zero.part,
            "flat": zero.flat.numel(), "bucket": zero.bucket.numel(),
            "fp32_grad_bytes": zero.grad.nbytes + zero.bucket.nbytes,
            "plan_grads_bytes": plan.grads_bytes, "weights_bytes": frozen + zero.flat.nbytes,
            "plan_weights_bytes": plan.weights_bytes, "grads_left": left,
            "hooked": sum(bool(getattr(p, "_post_accumulate_grad_hooks", None))
                          for p in model.parameters()),
            "reduces": reduces}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def step_run(mesh, args, plant: bool = False) -> dict:
    cfg, model = model_from(args)
    tcfg = pstep.TrainConfig(**args["tcfg"])
    window = args["samples"]                      # micro-step a's row d: window[a * n_data + d]
    batch = pdata.collate(window[mesh.d::mesh.n_data], cfg, device="cpu")
    shard_params(model, cfg, mesh)
    zero = Zero2(pstep.split_frozen(model, tcfg.freeze_modules)[0], mesh)
    state = zero.init_state(tcfg.adam_mu_dtype)
    step = pstep.make_mesh_train_step(cfg, tcfg, pstep.make_optimizer(tcfg), zero)
    left = watch(zero)
    metrics = []
    with Reductions(skip=plant) as reduces:
        for _ in range(args["windows"]):
            model, state, m = step(model, state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    # the replicated parameters must stay bit-equal across the model ranks
    in_sync = True
    for name, p in model.named_parameters():
        if split_dim(name) is None:
            parts = [torch.empty_like(p) for _ in range(mesh.n_model)]
            dist.all_gather(parts, p.detach(), group=mesh.model_group)
            in_sync &= all(torch.equal(parts[0], x) for x in parts)
    plan = plan_for(cfg, mesh, tcfg, zero)
    return {"metrics": metrics, "state": gather_state(model, zero, state, args["windows"]),
            "replicated_in_sync": in_sync,
            "zero": zero_facts(model, zero, plan, left, reduces.calls)}


def case_step(mesh, args):
    out = step_run(mesh, args)
    if args.get("plant"):
        out["planted"] = step_run(mesh, args, plant=True)
    out["also"] = [step_run(mesh, {**args, **extra}) for extra in args.get("also", ())]
    return out


def case_trainer(mesh, args):
    cfg, model = model_from(args)
    tcfg = pstep.TrainConfig(**args["tcfg"])
    trainer = Trainer(model, cfg, tcfg, TrainerConfig(**args["run"]), args["samples"], mesh=mesh)
    return {"last": trainer.train()}


def main():
    case, rank, world, n_data, n_model, io_dir = sys.argv[1:7]
    rank, world, n_data, n_model = (int(x) for x in (rank, world, n_data, n_model))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(io_dir, 'rendezvous')}",
                            rank=rank, world_size=world)
    mesh = make_mesh(n_data, n_model, "cpu")
    with open(os.path.join(io_dir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    sharding.GRAD_BUCKET = args.get("bucket", sharding.GRAD_BUCKET)
    out = {"ce": case_ce, "step": case_step, "trainer": case_trainer}[case](mesh, args)
    dist.barrier()
    dist.destroy_process_group()
    if "jax" in sys.modules:
        raise SystemExit("torch_mesh_worker: jax was imported")
    if rank == 0:
        torch.save(out, os.path.join(io_dir, "out.pt"))


if __name__ == "__main__":
    main()

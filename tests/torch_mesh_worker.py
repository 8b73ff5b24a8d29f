"""One rank of a multi-process case of ``tests/test_torch_mesh.py``.

    python tests/torch_mesh_worker.py CASE RANK WORLD N_DATA N_MODEL IO_DIR

The ranks meet over gloo at ``file://IO_DIR/rendezvous`` (the test
workers share the host, so no port is claimed). ``IO_DIR/args.pkl`` holds
the case's inputs (numpy arrays, lists, dicts: nothing that needs JAX to
unpickle); rank 0 writes the results to ``IO_DIR/out.pt``. Imports torch
and the port only, and checks at the end that JAX was never imported.

Cases: ``ce`` (``vocab_parallel_ce`` and its gradients), ``step`` (the mesh
step over windows of collated samples, then the gathered state) and
``trainer`` (``Trainer(mesh=)`` over an in-memory dataset).
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


def case_step(mesh, args):
    cfg, model = model_from(args)
    tcfg = pstep.TrainConfig(**args["tcfg"])
    window = args["samples"]                      # micro-step a's row d: window[a * n_data + d]
    batch = pdata.collate(window[mesh.d::mesh.n_data], cfg, device="cpu")
    shard_params(model, cfg, mesh)
    zero = Zero2(pstep.split_frozen(model, tcfg.freeze_modules)[0], mesh)
    state = zero.init_state(tcfg.adam_mu_dtype)
    step = pstep.make_mesh_train_step(cfg, tcfg, pstep.make_optimizer(tcfg), zero)
    metrics = []
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
    return {"metrics": metrics, "state": gather_state(model, zero, state, args["windows"]),
            "replicated_in_sync": in_sync}


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
    out = {"ce": case_ce, "step": case_step, "trainer": case_trainer}[case](mesh, args)
    dist.barrier()
    dist.destroy_process_group()
    if "jax" in sys.modules:
        raise SystemExit("torch_mesh_worker: jax was imported")
    if rank == 0:
        torch.save(out, os.path.join(io_dir, "out.pt"))


if __name__ == "__main__":
    main()

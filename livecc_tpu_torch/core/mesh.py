"""The (data, model) process mesh of multi-device training.

Port of ``livecc_tpu/core/mesh.py``. JAX builds one ``jax.sharding.Mesh``
over its devices and lets XLA place the collectives; the port runs one
process a card (``torchrun``) and issues them itself over two families of
process groups:

  * ``data`` -- data parallelism: each data rank takes its own batch rows,
    and the fp32 gradient and the AdamW state are partitioned over it
    (ZeRO-2, ``parallel/sharding.py``);
  * ``model`` -- tensor parallelism (Megatron): attention heads, the MLP
    width and the vocabulary are split over it
    (``models/qwen2_vl/text.py``, ``ops/chunked_ce.py:vocab_parallel_ce``).

The rank layout is JAX's ``np.asarray(devices).reshape(n_data, n_model)``:
rank = d * n_model + m, the model axis innermost, so the ranks of one
model group are neighbours (one host's NVLink). ``mesh=None`` everywhere
is the single-card path.

``init_mesh(spec, device)`` starts the default process group from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``): NCCL on ``cuda`` (each rank on
``cuda:LOCAL_RANK``), gloo on ``cpu``. ``make_mesh`` builds the groups on
an already started default group (the tests start theirs over ``file://``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def layout(n_data: int, n_model: int) -> np.ndarray:
    """int [n_data, n_model]: the rank at each mesh position (JAX's
    ``make_mesh`` reshape of the device list)."""
    return np.arange(n_data * n_model).reshape(n_data, n_model)


def parse_mesh(spec: str) -> tuple[int, int]:
    """"DATAxMODEL" -> (n_data, n_model)."""
    try:
        n_data, n_model = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: expected DATAxMODEL, e.g. 4x2") from None
    if n_data < 1 or n_model < 1:
        raise ValueError(f"--mesh {spec!r}: both axes must be >= 1")
    return n_data, n_model


@dataclasses.dataclass
class Mesh:
    """This rank's place in the mesh and the two groups it belongs to."""

    n_data: int
    n_model: int
    rank: int
    data_group: dist.ProcessGroup      # the n_data ranks of this rank's model index
    model_group: dist.ProcessGroup     # the n_model ranks of this rank's data index
    device: torch.device

    @property
    def d(self) -> int:
        return self.rank // self.n_model

    @property
    def m(self) -> int:
        return self.rank % self.n_model


def make_mesh(n_data: int, n_model: int, device) -> Mesh:
    """The mesh over the started default group, whose size must be
    ``n_data * n_model``. Every rank builds every group, in one order (as
    ``new_group`` requires), and keeps the two it belongs to."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != WORLD_SIZE {world}")
    ranks = layout(n_data, n_model)
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group(ranks[:, m].tolist())
        if rank in ranks[:, m]:
            data_group = g
    for d in range(n_data):
        g = dist.new_group(ranks[d].tolist())
        if rank in ranks[d]:
            model_group = g
    return Mesh(n_data, n_model, rank, data_group, model_group, torch.device(device))


def torchrun_env() -> dict[str, str]:
    """torchrun's variables; raises where one is missing."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--mesh needs torchrun's environment; {missing} not set (run "
                           f"torchrun --nproc_per_node N -m livecc_tpu_torch.train.cli "
                           f"--mesh DATAxMODEL ...)")
    return {k: os.environ[k] for k in TORCHRUN_ENV}


def init_mesh(spec: str, device: str) -> Mesh:
    """Start the default group from torchrun's environment and build the
    ``spec`` mesh on it: NCCL with this rank on ``cuda:LOCAL_RANK`` for
    ``device`` "cuda", gloo for "cpu". Raises where the environment is
    missing or DATA x MODEL is not ``WORLD_SIZE``."""
    n_data, n_model = parse_mesh(spec)
    env = torchrun_env()
    world = int(env["WORLD_SIZE"])
    if n_data * n_model != world:
        raise ValueError(f"--mesh {spec}: {n_data} x {n_model} != WORLD_SIZE {world}")
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--mesh on cuda: CUDA is not available (--device cpu runs gloo)")
        dev = torch.device("cuda", int(env["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev)
    elif kind == "cpu":
        dev = torch.device("cpu")
        dist.init_process_group("gloo")
    else:
        raise ValueError(f"--mesh: device {device!r} (cuda or cpu)")
    return make_mesh(n_data, n_model, dev)


def close_mesh(mesh: Optional[Mesh]) -> None:
    """Destroy the process groups a mesh runs on (after its last collective)."""
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()

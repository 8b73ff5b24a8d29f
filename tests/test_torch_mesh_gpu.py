"""The mesh step over NCCL on the card, against the single-device step.

Marked ``gpu``: skips where ``torch.cuda.is_available()`` is false. On a
machine with the card (no jax there, so ``tests/conftest.py`` stays out):

    python -m pytest --noconftest -m gpu tests/test_torch_mesh_gpu.py -q

One process is world size 1: ``init_mesh("1x1", "cuda")`` from torchrun's
variables set here (a free localhost port), the NCCL backend, the tiny
model in fp32 and in bf16. Two windows of ``make_mesh_train_step`` (the
TP layers, ``vocab_parallel_ce``, the flat ZeRO-2 update, every
collective over one rank) against ``make_train_step`` on a copy of the
same model and batch: losses within 1e-6 relative (the first window's
forward is the same arithmetic), tokens equal, every parameter within
1e-5 relative + 1e-6 absolute in fp32 and within a bf16 step in bf16 (the
global norm sums in another order).
"""

import copy
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.core.mesh import close_mesh, init_mesh
from livecc_tpu_torch.models.qwen2_vl.model import init_params
from livecc_tpu_torch.parallel.sharding import Zero2, shard_params
from livecc_tpu_torch.train import data as pdata
from livecc_tpu_torch.train import step as pstep

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_mesh_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def samples(cfg, n=4, seed=6):
    rng = np.random.RandomState(seed)
    out = []
    for length in (30, 44, 26, 36)[:n]:
        ids = rng.randint(8, cfg.text.vocab_size, size=(1, length)).astype(np.int32)
        labels = ids.copy()
        labels[:, : length // 2] = -100
        pos = np.broadcast_to(np.arange(length)[None, None], (3, 1, length)).astype(np.int32)
        out.append({"input_ids": ids, "labels": labels, "position_ids": np.ascontiguousarray(pos),
                    "pixel_patches": None, "video_grid_thw": None, "image_patches": None,
                    "image_grid_thw": None})
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nccl_world_one_step_equals_the_single_device_step(cuda, monkeypatch, dtype):
    for name, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                        ("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(free_port()))):
        monkeypatch.setenv(name, value)
    cfg = tiny_config()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda, dtype)
    ref_model = copy.deepcopy(model)
    tcfg = pstep.TrainConfig(learning_rate=1e-4, total_steps=10, warmup_ratio=0.1,
                             ce_chunk_size=16, adam_eps=1e-6, max_grad_norm=0.05)
    batch = pdata.collate(samples(cfg), cfg, device=cuda)

    opt = pstep.make_optimizer(tcfg)
    state = opt.init(pstep.split_frozen(ref_model, tcfg.freeze_modules)[0])
    ref_step = pstep.make_train_step(cfg, tcfg, opt)
    ref = []
    for _ in range(2):
        ref_model, state, m = ref_step(ref_model, state, batch)
        ref.append(m)

    mesh = init_mesh("1x1", "cuda")
    try:
        assert dist.get_backend() == "nccl" and mesh.device == torch.device("cuda", 0)
        shard_params(model, cfg, mesh)
        zero = Zero2(pstep.split_frozen(model, tcfg.freeze_modules)[0], mesh)
        mstate = zero.init_state(None)
        step = pstep.make_mesh_train_step(cfg, tcfg, opt, zero)
        for m_ref in ref:
            model, mstate, m = step(model, mstate, batch)
            np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), rtol=1e-6)
            assert int(m["tokens"]) == int(m_ref["tokens"]) > 0
    finally:
        close_mesh(mesh)
    rtol, atol = (1e-5, 1e-6) if dtype == torch.float32 else (2 ** -7, 1e-6)
    got = dict(model.named_parameters())
    for name, p in ref_model.named_parameters():
        np.testing.assert_allclose(got[name].detach().float().cpu().numpy(),
                                   p.detach().float().cpu().numpy(), rtol=rtol, atol=atol,
                                   err_msg=name)

"""Tensor-parallel serving over NCCL on the card, against the unsplit model.

Marked ``gpu``: skips where ``torch.cuda.is_available()`` is false. On a
machine with the card (no jax there, so ``tests/conftest.py`` stays out):

    python -m pytest --noconftest -m gpu tests/test_torch_tp_serving_gpu.py -q

One process is world size 1: ``init_mesh("1x1", "cuda")`` from torchrun's
variables set here (a free localhost port), the NCCL backend, the tiny model
in fp32 and in bf16, ``shard_params`` at M = 1 (nothing is sliced; every
collective of the split tower is issued). The engine over three chunks and
the int8-KV pool over two ticks must give the unsplit model's tokens; their
decode steps are captured as CUDA graphs with the collectives inside (each
all-reduce and all-gather is counted where a capture is under way) and
replayed. The storage repair of ``shard_params`` is checked on ``cuda`` at
M = 2 (one rank's slices, no collective): every split tensor owns storage
of its shard's size and the card's allocated bytes fall by the rest.
"""

import collections
import copy
import socket

import pytest
import torch
import torch.distributed as dist

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.core.mesh import Mesh, close_mesh, init_mesh
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.engine import GenerationParams, LiveCCEngine
from livecc_tpu_torch.engine.graphs import graphs_for
from livecc_tpu_torch.models.qwen2_vl.model import init_params
from livecc_tpu_torch.parallel.sharding import shard_params, split_dim
from livecc_tpu_torch.serve import StreamServer
from torch_tp_serving_worker import GEN, engine_chunks, pool_ticks

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_tp_serving_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def serve(model, cfg):
    """The engine's three chunks (a KV cache in the model's dtype) and the
    int8-KV pool's two ticks."""
    gen = GenerationParams(**GEN)
    dtype = next(model.parameters()).dtype
    texts, _ = engine_chunks(LiveCCEngine(model, cfg, ByteTokenizer(), cache_len=256,
                                          cache_dtype=dtype), gen, 3)
    server = StreamServer(LiveCCEngine(model, cfg, ByteTokenizer(), cache_len=256,
                                       cache_dtype=torch.int8), gen, capacity=2)
    return texts, pool_ticks(server, 2)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nccl_world_one_serves_the_unsplit_tokens(cuda, monkeypatch, dtype):
    for name, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                        ("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(free_port()))):
        monkeypatch.setenv(name, value)
    cfg = tiny_config()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda, dtype)
    ref = serve(copy.deepcopy(model), cfg)
    issued = collections.Counter()

    def counted(fn):
        def run(*args, **kw):
            issued[(fn.__name__, torch.cuda.is_current_stream_capturing())] += 1
            return fn(*args, **kw)
        return run

    for name in ("all_reduce", "all_gather_into_tensor"):
        monkeypatch.setattr(dist, name, counted(getattr(dist, name)))
    mesh = init_mesh("1x1", "cuda")
    try:
        assert dist.get_backend() == "nccl"
        shard_params(model, cfg, mesh)
        graphs = graphs_for(model, cfg)
        graphs.reset_stats()
        got = serve(model, cfg)
        stats = graphs.stats()
    finally:
        close_mesh(mesh)
    assert got == ref
    assert stats["captures"] > 0 and stats["replays"] > 0, stats
    for name in ("all_reduce", "all_gather_into_tensor"):
        assert issued[(name, True)] > 0 and issued[(name, False)] > 0, issued


def test_shard_params_frees_the_rest_on_cuda(cuda):
    """M = 2, rank 1's slices of a bf16 tiny model on the card."""
    cfg = tiny_config()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda, torch.bfloat16)
    named = dict(model.named_parameters())
    split = sum(p.numel() * p.element_size() for n, p in named.items()
                if split_dim(n) is not None)
    del named
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    shard_params(model, cfg, Mesh(1, 2, 1, None, None, cuda))
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated()
    for name, p in model.named_parameters():
        if split_dim(name) is not None:
            assert p.untyped_storage().nbytes() == p.numel() * p.element_size(), name
    # the caching allocator rounds each block up to 512 bytes
    assert abs(freed - split // 2) <= 512 * len(list(model.parameters())), (freed, split)

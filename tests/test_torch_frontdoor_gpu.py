"""The front door's parts that run only on the card: K3's gradient through
its autograd ``Function`` and ``load_checkpoint`` onto CUDA.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) where
``torch.cuda.is_available()`` is false. On a machine with the card:

    python -m pytest --noconftest -m gpu tests/test_torch_frontdoor_gpu.py -q

K3's gradients (both forms, and a tiny unfrozen ViT's parameter gradients
through a training loss) are held to the CPU plain path's autograd by
``kernel_check.grad_close`` (the same-dtype CPU gradient sets the rounding
allowed around the fp32 one), a limit that ``kernel_check.zeroed_k3_backward``
(a backward that returns zeros) must fail.
"""

import pytest
import torch

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.models.qwen2_vl import init_params
from livecc_tpu_torch.models.qwen2_vl.convert import load_checkpoint
from livecc_tpu_torch.ops import build
from livecc_tpu_torch.ops.vit_attention import vit_group_attention, vit_segment_attention
from livecc_tpu_torch.tools import kernel_check
from livecc_tpu_torch.tools.checkpoint import save_checkpoint
from livecc_tpu_torch.tools.train_session import tiny_vit_grads

pytestmark = pytest.mark.gpu
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_frontdoor_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def attention_grads(form, dtype, dev, inputs):
    """(out, dq, dk, dv) of K3's ``form`` on ``dev`` in ``dtype``, as fp32 CPU tensors."""
    q, k, v, dout = (x.to(device=dev, dtype=dtype, copy=True) for x in inputs)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    if form == "group":
        out = vit_group_attention(q, k, v)
    else:
        cu = torch.tensor([0, 300, 1180, 1400], dtype=torch.int32, device=dev)
        out = vit_segment_attention(q, k, v, cu, 880)
    out.backward(dout)
    return [x.detach().float().cpu() for x in (out, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["group", "segment"])
def test_k3_gradient_matches_the_cpu_plain_autograd(cuda, form, dtype):
    shape = (2, 700, 16, 80) if form == "group" else (1400, 16, 80)
    gen = torch.Generator().manual_seed(0)
    inputs = [torch.randn(shape, generator=gen) for _ in range(4)]
    before = build.launch_counts["vit_group_attention"]
    got = attention_grads(form, dtype, cuda, inputs)
    assert build.launch_counts["vit_group_attention"] == before + 1
    ref = attention_grads(form, dtype, "cpu", inputs)
    ref32 = attention_grads(form, torch.float32, "cpu", inputs)
    assert kernel_check.close(got[0], ref[0], dtype) <= 1.0
    for g, r, r32 in zip(got[1:], ref[1:], ref32[1:]):
        assert kernel_check.grad_close(g, r, r32) <= 1.0
    with kernel_check.zeroed_k3_backward():
        bad = attention_grads(form, dtype, cuda, inputs)
    assert all(kernel_check.grad_close(g, r, r32) > 1.0
               for g, r, r32 in zip(bad[1:], ref[1:], ref32[1:]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_unfrozen_tiny_vit_gradients(cuda, dtype):
    ref32 = tiny_vit_grads("cpu")
    ref = tiny_vit_grads("cpu", dtype)
    build.reset_launch_counts()
    got = tiny_vit_grads("cuda", dtype)
    # one K3 launch a ViT block in each of the step's two micro-batches
    assert build.launch_counts["vit_group_attention"] == 2 * tiny_config().vision.depth
    assert max(kernel_check.grad_close(got[n], ref[n], ref32[n]) for n in ref32) <= 1.0
    with kernel_check.zeroed_k3_backward():
        bad = tiny_vit_grads("cuda", dtype)
    assert max(kernel_check.grad_close(bad[n], ref[n], ref32[n]) for n in ref32) > 1.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_load_checkpoint_onto_cuda_equals_the_cpu_load(cuda, tmp_path, dtype):
    cfg = tiny_config()
    model = init_params(cfg, torch.Generator().manual_seed(4), "cpu", torch.float32)
    config = tmp_path / "config.json"
    config.write_text('{"vocab_size": 1024, "hidden_size": 64, "intermediate_size": 128, '
                      '"num_hidden_layers": 2, "num_attention_heads": 4, '
                      '"num_key_value_heads": 2, "rope_scaling": {"mrope_section": [2, 3, 3]}, '
                      '"vision_config": {"depth": 2, "embed_dim": 64, "num_heads": 4, '
                      '"hidden_size": 64}}')
    save_checkpoint(model, cfg, str(tmp_path / "ckpt"), str(config), shard_bytes=200_000)
    cfg_cpu, on_cpu = load_checkpoint(str(tmp_path / "ckpt"), "cpu", dtype)
    cfg_gpu, on_gpu = load_checkpoint(str(tmp_path / "ckpt"), "cuda", dtype)
    assert cfg_gpu == cfg_cpu and cfg_gpu.text == cfg.text and cfg_gpu.vision == cfg.vision
    gpu = dict(on_gpu.named_parameters())
    for name, p in on_cpu.named_parameters():
        assert gpu[name].device.type == "cuda" and gpu[name].dtype == dtype
        assert torch.equal(gpu[name].cpu(), p), name

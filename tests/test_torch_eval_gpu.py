"""The MCQ harness (``livecc_tpu_torch/eval/mcq.py``) on the card.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) where
``torch.cuda.is_available()`` is false. On a machine with the card:

    python -m pytest --noconftest -m gpu tests/test_torch_eval_gpu.py -q

The tiny model in fp32 (weights drawn on the CPU, copied to the card) scores
two items through K3 and K4's forward on the card and through their plain
versions on the CPU; ``kernel_check``'s blocked plain versions (K4's
forward by query rows, K3 group by group), which hold the kernels at the
720p item's shape in ``chip_smoke.py``, equal the whole plain versions on
the card at a size where both fit.
"""

import copy

import numpy as np
import pytest
import torch

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.eval import mcq
from livecc_tpu_torch.models.qwen2_vl import init_params
from livecc_tpu_torch.ops import build
from livecc_tpu_torch.tools import kernel_check
from livecc_tpu_torch.vision_io.budget import VisionBudget

pytestmark = pytest.mark.gpu
LETTERS = ("A", "B", "C", "D")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_eval_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class Frames:
    """``VideoReader``'s API over 8 frames of 56 x 56 at 4 fps (seed from the path)."""

    def __init__(self, path):
        seed = int(path[-5])
        self.frames = np.random.RandomState(seed).randint(0, 256, (8, 56, 56, 3), dtype=np.uint8)
        self.avg_fps, self.frame_size = 4.0, (56, 56)
        self.pts_seconds = np.arange(8) / 4.0

    def __len__(self):
        return 8

    def get_batch(self, indices, out_hw=None):
        assert tuple(out_hw) == self.frame_size
        return self.frames[np.asarray(indices)]


def predictors(device):
    """(CPU, card) predictors on the same tiny fp32 weights."""
    cfg = tiny_config()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    budget = VisionBudget(video_min_pixels=56 * 56)
    return [mcq.MCQPredictor(m, cfg, ByteTokenizer(), max_frames=4, budget=budget,
                             video_loader=Frames)
            for m in (model, copy.deepcopy(model).to(device))]


ITEMS = [mcq.MCQItem(video=f"clip{i}.mp4", question=f"What happens in clip {i}?",
                     options=["A. x", "B. y", "C. z", "D. w"]) for i in range(3)]


def test_letter_logits_on_the_card_match_the_cpu(cuda):
    cpu, gpu = predictors(cuda)
    group = [cpu.encode_item(x) for x in ITEMS[:2]]
    build.reset_launch_counts()
    got = gpu.letter_logits(group, LETTERS)
    counts = dict(build.launch_counts)
    want = cpu.letter_logits(group, LETTERS)
    assert got.device.type == "cuda" and got.shape == (2, 4)
    assert kernel_check.close(got.cpu(), want, torch.float32) <= 1.0
    assert counts.get("vit_group_attention", 0) > 0 and counts.get("train_attention_fwd", 0) > 0
    assert not counts.get("train_attention_bwd")


def test_batched_letters_equal_single_on_the_card(cuda):
    _, gpu = predictors(cuda)
    single = gpu.predict(ITEMS, batch_size=1)
    assert gpu.predict(ITEMS, batch_size=2) == single == gpu.predict(ITEMS, batch_size=3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_plain_versions_equal_the_whole_ones(cuda, dtype):
    from livecc_tpu_torch.ops.attention import prescaled
    from livecc_tpu_torch.ops.train_attention import train_attention_fwd_plain
    from livecc_tpu_torch.ops.vit_attention import vit_group_attention_plain

    gen = torch.Generator(device=cuda).manual_seed(0)
    s, (hq, hk, d) = 2300, (28, 4, 128)
    q, k, v = (torch.randn((1, s, h, d), generator=gen, device=cuda).to(dtype)
               for h in (hq, hk, hk))
    qs = prescaled(q)
    seg = torch.zeros((1, s), dtype=torch.int32, device=cuda)
    seg[0, :2000] = 1
    o, lse = train_attention_fwd_plain(qs, k, v, seg)
    bo, blse = kernel_check.train_attention_fwd_blocked(qs, k, v, seg, rows=512)
    assert kernel_check.close(bo, o, dtype) <= 1.0
    assert kernel_check.close(blse, lse, torch.float32) <= 1.0
    vq, vk, vv = (torch.randn((4, 880, 16, 80), generator=gen, device=cuda).to(dtype)
                  for _ in range(3))
    assert kernel_check.close(kernel_check.vit_group_attention_blocked(vq, vk, vv),
                              vit_group_attention_plain(vq, vk, vv), dtype) <= 1.0

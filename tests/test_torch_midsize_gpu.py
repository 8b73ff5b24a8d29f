"""The port's forward at Qwen2-VL-7B's width against HF's golden, on the card.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) where
``torch.cuda.is_available()`` is false. On a machine with the card:

    python -m pytest --noconftest -m gpu tests/test_torch_midsize_gpu.py -q

``tools/midsize.py`` builds the golden's model (7B width, 4 LLM layers, 4
ViT blocks; 2.1 B weights from ``utils/param_recipe.py``) on the card and
runs the text, multimodal, streaming-continuation and vision-tower cases
through the kernels (K4's forward, K3's group and bounds forms, K1). fp32
meets the golden within JAX's limits (``tests/test_midsize_parity.py``:
ATOL 3e-3, RTOL 2e-3, argmax on decided positions, coverage >= 0.99); bf16
within ``midsize.BF16``.
"""

import pytest
import torch

from livecc_tpu_torch.ops import build
from livecc_tpu_torch.tools import midsize

pytestmark = pytest.mark.gpu
KERNELS = ("vit_group_attention", "train_attention_fwd", "flash_prefill")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_midsize_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype, limits", [(torch.float32, midsize.FP32),
                                           (torch.bfloat16, midsize.BF16)], ids=["fp32", "bf16"])
def test_forward_at_width_meets_the_hf_golden(cuda, dtype, limits):
    golden, cfg, model = midsize.load(cuda, dtype)
    build.reset_launch_counts()
    out = midsize.run_cases(model, cfg, golden)
    counts = dict(build.launch_counts)
    assert all(counts.get(k, 0) > 0 for k in KERNELS), counts
    report = midsize.check(golden, out, limits)
    assert report["text"]["decided"] >= limits.coverage

"""The web demo's parts on the card: ``device_preprocess`` on CUDA against
the CPU, and the tiny model's web demo on CUDA against the CPU.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) where
``torch.cuda.is_available()`` is false. On a machine with the card:

    python -m pytest --noconftest -m gpu tests/test_torch_demo_gpu.py -q
"""

import json
import os

import numpy as np
import pytest
import torch

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.demo import app, cli
from livecc_tpu_torch.engine import LiveCCEngine
from livecc_tpu_torch.models.qwen2_vl.convert import convert_state_dict
from livecc_tpu_torch.ops import build
from livecc_tpu_torch.vision_io import device_preprocess
from torch_demo_http import get, npy_loader, post, serving, write_clip

pytestmark = pytest.mark.gpu
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "hf_tiny.npz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_demo_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_device_preprocess_on_cuda_matches_the_cpu(cuda):
    """A 2-frame chunk of 720x1280 resized to 308x560 (g = 880): within 1e-4
    of the CPU in fp32; two launches bit-equal."""
    frames = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 720, 1280, 3),
                                                               dtype=np.uint8))
    kw = dict(out_h=308, out_w=560)
    want = device_preprocess(frames, **kw)
    got = device_preprocess(frames.to(cuda), **kw)
    assert got.device.type == "cuda" and got.shape == want.shape == (880, 1176)
    assert (got.cpu() - want).abs().max().item() <= 1e-4
    assert torch.equal(got, device_preprocess(frames.to(cuda), **kw))


def test_tiny_web_demo_on_cuda_gives_the_cpu_ticks(cuda, tmp_path, monkeypatch):
    """The hf_tiny weights in fp32 behind the demo on each device: the same
    tick bodies; the card's QA turn answers; K1, K2 and K3 launched."""
    g = np.load(GOLDEN)
    state = {k[len("state::"):]: g[k] for k in g.files if k.startswith("state::")}

    def build_engine(path, device, **kw):
        model = convert_state_dict(state, tiny_config(), device)
        return LiveCCEngine(model, tiny_config(), ByteTokenizer(), cache_len=1024,
                            cache_dtype=torch.float32)

    monkeypatch.setattr(cli, "build_engine", build_engine)
    path = write_clip(str(tmp_path / "clip.npy"))
    ticks, answers = {}, {}
    for device in ("cpu", "cuda"):
        server = app.DemoServer(path, None, "describe", device=device, video_loader=npy_loader)
        build.reset_launch_counts()
        with serving(server, app.make_handler) as url:
            ticks[device] = [get(f"{url}/tick?t={t}") for t in (2.0, 3.0, 4.0, 6.5, 8.0)]
            answers[device] = post(url + "/qa", "what is shown?")
    assert ticks["cuda"] == ticks["cpu"]
    assert sum(len(json.loads(body)) for body in ticks["cuda"]) >= 5 and answers["cuda"]
    for name in ("vit_group_attention", "flash_prefill", "flash_decode"):
        assert build.launch_counts[name] > 0, name

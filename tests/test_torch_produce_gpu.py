"""The data-production path (ASR and the corpus scorers) on the card.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) where
``torch.cuda.is_available()`` is false. On a machine with the card:

    python -m pytest --noconftest -m gpu tests/test_torch_produce_gpu.py -q

fp32 tiny models, weights drawn on the CPU from a seed and copied to the
card: the tiny Whisper gives the CPU's greedy tokens (and, through a
checkpoint, ``WhisperTranscriber`` the CPU's words); the scorers
(``lm_loss_scores``, ``talking_head_prob``, ``TalkingHeadPredictor``) run
K3 and K4's forward on the card and agree with their plain versions on the
CPU within 1e-4.
"""

import copy

import numpy as np
import pytest
import torch

from livecc_tpu_torch.audio import mel as mel_mod
from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.models import whisper as pw
from livecc_tpu_torch.models.qwen2_vl import init_params
from livecc_tpu_torch.models.qwen2_vl.model import prepare_vision_inputs
from livecc_tpu_torch.ops import build
from livecc_tpu_torch.tools import asr, filters, lmm4asd
from livecc_tpu_torch.tools.checkpoint import save_whisper_checkpoint
from livecc_tpu_torch.vision_io.patchify import patchify_video

pytestmark = pytest.mark.gpu
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_produce_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tiny_whisper():
    cfg = pw.tiny_whisper_config()
    return cfg, pw.init_whisper(cfg, torch.Generator().manual_seed(0))


def test_tiny_whisper_tokens_on_the_card_match_the_cpu(cuda):
    cfg, model = tiny_whisper()
    gpu = copy.deepcopy(model).to(cuda)
    for seed in range(3):
        mel = np.random.RandomState(seed).randn(cfg.num_mel_bins,
                                               2 * cfg.max_source_positions).astype(np.float32)
        want = pw.greedy_transcribe_tokens(model, cfg, mel, [cfg.decoder_start_token_id])
        got = pw.greedy_transcribe_tokens(gpu, cfg, mel, [cfg.decoder_start_token_id])
        assert got == want and len(got) > 0
        with torch.no_grad():
            enc = pw.whisper_encode(gpu, cfg, torch.from_numpy(mel)[None])
            torch.testing.assert_close(enc.cpu(), pw.whisper_encode(
                model, cfg, torch.from_numpy(mel)[None]), atol=TOL, rtol=TOL)


def test_transcriber_from_a_checkpoint_on_the_card(cuda, tmp_path, monkeypatch):
    cfg, model = tiny_whisper()
    ckpt = str(tmp_path / "whisper")
    save_whisper_checkpoint(model, cfg, ckpt)
    orig = mel_mod.log_mel_spectrogram

    def small_mel(seg, num_mel_filters):   # the tiny model's source length
        return orig(seg, num_mel_filters, pad_to_chunk=False)[:, : 2 * cfg.max_source_positions]

    monkeypatch.setattr(mel_mod, "log_mel_spectrogram", small_mel)
    pcm = (np.random.RandomState(0).randn(40000) * 0.1).astype(np.float32)
    kw = dict(chunk_seconds=1, decode_text=lambda ids: " ".join(f"w{i}" for i in ids),
              audio_loader=lambda path, sr: pcm, dtype=torch.float32)
    words = {d: asr.WhisperTranscriber(ckpt, device=d, **kw)("clip.mp4") for d in ("cpu", "cuda")}
    assert words["cuda"] == words["cpu"] and len(words["cpu"]) > 0


def tiny_models(device):
    cfg = tiny_config()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    return cfg, model, copy.deepcopy(model).to(device)


class Frames:
    """``VideoReader``'s API over seeded frames of 40 x 64, nearest-resized."""

    def __init__(self, path):
        seed = int(path[1:-4])
        self.frames = np.random.RandomState(seed).randint(0, 256, (10 + seed, 40, 64, 3),
                                                          dtype=np.uint8)

    def __len__(self):
        return len(self.frames)

    def get_batch(self, indices, out_hw=None):
        out = self.frames[np.asarray(indices)]
        (h, w), (rh, rw) = self.frames.shape[1:3], out_hw
        return out[:, np.arange(rh) * h // rh][:, :, np.arange(rw) * w // rw]


def test_scorers_on_the_card_match_the_cpu(cuda):
    cfg, cpu, gpu = tiny_models(cuda)
    tok = ByteTokenizer()
    samples = [{"title": "t", "transcript": "hello world this is a test"},
               {"previous": "earlier words", "transcript": " ".join(["more"] * 120)}]
    build.reset_launch_counts()
    got = filters.lm_loss_scores(gpu, cfg, tok, samples)
    assert build.launch_counts["train_attention_fwd"] > 0
    np.testing.assert_allclose(got, filters.lm_loss_scores(cpu, cfg, tok, samples),
                               atol=TOL, rtol=TOL)

    frames = np.random.RandomState(4).randint(0, 256, (4, 3, 56, 56), dtype=np.uint8)
    patches, grid = patchify_video(frames)
    probs = [filters.talking_head_prob(m, cfg, tok, prepare_vision_inputs(cfg, patches, [grid], d),
                                       grid) for m, d in ((gpu, cuda), (cpu, "cpu"))]
    np.testing.assert_allclose(probs[0], probs[1], atol=TOL, rtol=TOL)

    videos = [f"v{i}.mp4" for i in range(5)]
    kw = dict(num_frames=4, frame_hw=(28, 28), batch_size=3, video_loader=Frames)
    build.reset_launch_counts()
    got = lmm4asd.TalkingHeadPredictor(gpu, cfg, tok, **kw).predict_probs(videos)
    counts = dict(build.launch_counts)
    assert counts["vit_group_attention"] > 0 and counts["train_attention_fwd"] > 0, counts
    want = lmm4asd.TalkingHeadPredictor(cpu, cfg, tok, **kw).predict_probs(videos)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)

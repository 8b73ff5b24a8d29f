"""The port's ASR stage (``livecc_tpu_torch/audio``, ``models/whisper``,
``tools/asr.py`` and the audio I/O of ``vision_io/video_reader.py``)
against the JAX package's, on the CPU.

The tiny Whisper is HF's ``WhisperForConditionalGeneration`` drawn from a
seed. The JAX package takes its weights through its ``convert_torch_model``,
the port through ``whisper_params_from_jax`` (JAX's tree, as numpy) and
through its own ``convert_torch_model``. Both run in fp32: the logits agree
within 1e-5 and the greedy tokens are identical; against HF the port keeps
JAX's own limits (``tests/test_whisper.py``). The transcriber cases need the
native decoder (FFmpeg) and skip without it, as JAX's does.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livecc_tpu.audio import mel as jmel
from livecc_tpu.models import whisper as jw
from livecc_tpu.tools import asr as jasr
from livecc_tpu.vision_io import video_reader as jvr

from livecc_tpu_torch.audio import mel
from livecc_tpu_torch.models import whisper as pw
from livecc_tpu_torch.models.whisper.model import sinusoids
from livecc_tpu_torch.tools import asr
from livecc_tpu_torch.tools.checkpoint import save_whisper_checkpoint
from livecc_tpu_torch.vision_io import video_reader as vr
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def tiny():
    """(config, HF model, JAX params, port model via the JAX tree)."""
    cfg = pw.tiny_whisper_config()
    hf_cfg = transformers.WhisperConfig(
        vocab_size=cfg.vocab_size, num_mel_bins=cfg.num_mel_bins,
        d_model=cfg.d_model, encoder_layers=cfg.encoder_layers,
        decoder_layers=cfg.decoder_layers,
        encoder_attention_heads=cfg.num_heads, decoder_attention_heads=cfg.num_heads,
        encoder_ffn_dim=cfg.ffn_dim, decoder_ffn_dim=cfg.ffn_dim,
        max_source_positions=cfg.max_source_positions,
        max_target_positions=cfg.max_target_positions,
        decoder_start_token_id=cfg.decoder_start_token_id,
        eos_token_id=cfg.eos_token_id, bos_token_id=0, pad_token_id=0,
    )
    torch.manual_seed(0)
    hf = transformers.WhisperForConditionalGeneration(hf_cfg).eval()
    params = jw.convert_torch_model(hf, jw.tiny_whisper_config())
    model = pw.whisper_params_from_jax(jax.tree.map(np.asarray, params), cfg)
    return cfg, hf, params, model


def mel_input(cfg, seed=0):
    """Tiny mel: frames = 2 * max_source_positions (conv2 stride 2)."""
    return np.random.RandomState(seed).randn(
        cfg.num_mel_bins, 2 * cfg.max_source_positions).astype(np.float32)


def jax_cfg(cfg):
    return jw.WhisperConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("seconds", [0.5, 2.0, 31.0], ids=["short", "2s", "past 30 s"])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_bit_equal_to_jax(seconds, n_mels):
    audio = (np.random.RandomState(1).randn(int(16000 * seconds)) * 0.2).astype(np.float32)
    got = mel.log_mel_spectrogram(audio, num_mel_filters=n_mels)
    want = jmel.log_mel_spectrogram(audio, num_mel_filters=n_mels)
    assert got.shape == (n_mels, 3000) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mel.mel_filter_bank(num_mel_filters=n_mels),
                                  jmel.mel_filter_bank(num_mel_filters=n_mels))
    unpadded = mel.log_mel_spectrogram(audio[:8000], n_mels, pad_to_chunk=False)
    np.testing.assert_array_equal(
        unpadded, jmel.log_mel_spectrogram(audio[:8000], n_mels, pad_to_chunk=False))


def test_encoder_and_decoder_logits_match_jax(tiny):
    cfg, _, params, model = tiny
    m = mel_input(cfg)
    ids = np.array([[cfg.decoder_start_token_id, 5, 9, 42, 7]], np.int64)
    want_enc = jw.whisper_encode(params, jax_cfg(cfg), jnp.asarray(m)[None])
    want = np.asarray(jw.whisper_decode(params, jax_cfg(cfg), jnp.asarray(ids, jnp.int32),
                                        want_enc))
    with torch.no_grad():
        enc = pw.whisper_encode(model, cfg, torch.from_numpy(m)[None])
        got = pw.whisper_decode(model, cfg, torch.from_numpy(ids), enc)
        # a position offset moves the learned positions as JAX's does
        got_off = pw.whisper_decode(model, cfg, torch.from_numpy(ids[:, 1:]), enc, 3)
    want_off = np.asarray(jw.whisper_decode(params, jax_cfg(cfg), jnp.asarray(ids[:, 1:]),
                                            want_enc, 3))
    assert got.dtype == torch.float32 and got.shape == (1, 5, cfg.vocab_size)
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_off.numpy(), want_off, atol=1e-5, rtol=1e-5)


def test_hf_conversion_within_jax_limits(tiny):
    """The port's ``convert_torch_model`` on HF's model: encoder and logits
    within ``tests/test_whisper.py``'s limits of HF, and every parameter
    equal to the one the JAX tree carries."""
    cfg, hf, _, bridged = tiny
    model = pw.convert_torch_model(hf, cfg)
    for (name, p), (name2, q) in zip(model.named_parameters(), bridged.named_parameters()):
        assert name == name2
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    m = mel_input(cfg)
    ids = np.array([[cfg.decoder_start_token_id, 5, 9, 42]], np.int64)
    with torch.no_grad():
        ref_enc = hf.model.encoder(torch.from_numpy(m)[None]).last_hidden_state
        ref = hf(input_features=torch.from_numpy(m)[None],
                 decoder_input_ids=torch.from_numpy(ids)).logits
        enc = pw.whisper_encode(model, cfg, torch.from_numpy(m)[None])
        got = pw.whisper_decode(model, cfg, torch.from_numpy(ids), enc)
    np.testing.assert_allclose(enc.numpy(), ref_enc.numpy(), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=3e-4, rtol=1e-3)


def test_init_draws_hf_scheme():
    """Random init: sinusoidal encoder positions (HF's table), norms at 1,
    biases 0, matrices N(0, 0.02); the same seed draws the same weights."""
    cfg = pw.tiny_whisper_config()
    a = pw.init_whisper(cfg, torch.Generator().manual_seed(0))
    b = pw.init_whisper(cfg, torch.Generator().manual_seed(0))
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
    pos = a.encoder.embed_positions.weight
    np.testing.assert_array_equal(pos.numpy(), sinusoids(cfg.max_source_positions, cfg.d_model))
    hf_pos = transformers.models.whisper.modeling_whisper.sinusoids(
        cfg.max_source_positions, cfg.d_model)
    np.testing.assert_allclose(pos.numpy(), hf_pos.numpy(), atol=1e-6)
    assert torch.equal(a.encoder.layers[0].self_attn_layer_norm.weight, torch.ones(cfg.d_model))
    assert torch.equal(a.decoder.layers[0].fc1.bias, torch.zeros(cfg.ffn_dim))
    assert abs(a.decoder.embed_tokens.weight.std().item() - 0.02) < 2e-3


@pytest.mark.parametrize("prompt, max_new, eos", [
    ([1], 8, None),                   # JAX's case against HF generate
    ([1, 5, 9], None, None),          # the default: max_target_positions, clamped
    ([1, 5, 9, 4, 3], 1000, -1),      # EOS unreachable: decodes to the clamp
], ids=["8 new", "default", "clamped"])
def test_greedy_tokens_identical_to_jax(tiny, prompt, max_new, eos):
    cfg, _, params, model = tiny
    if eos is not None:
        cfg = dataclasses.replace(cfg, eos_token_id=eos)
    m = mel_input(cfg, seed=3)
    want = jw.greedy_transcribe_tokens(params, jax_cfg(cfg), m, prompt_ids=prompt,
                                       max_new_tokens=max_new)
    got = pw.greedy_transcribe_tokens(model, cfg, m, prompt, max_new_tokens=max_new)
    assert got == want
    if eos is not None:
        assert len(got) == cfg.max_target_positions - len(prompt)


def test_load_safetensors_dir_and_config(tiny, tmp_path):
    """An HF checkpoint directory (``save_pretrained``: one shard, no
    ``proj_out``) loads through the port's reader: the config as JAX
    reads it, fp32 weights equal to HF's, bf16 ones rounded as JAX's."""
    cfg, hf, _, model = tiny
    ckpt = str(tmp_path / "whisper_tiny")
    hf.save_pretrained(ckpt, safe_serialization=True)
    got_cfg = pw.config_from_hf_json(ckpt)
    want_cfg = jw.config_from_hf_json(ckpt)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    loaded = pw.load_safetensors_dir(ckpt, got_cfg, device="cpu", dtype=torch.float32)
    for (name, p), (_, q) in zip(loaded.named_parameters(), model.named_parameters()):
        assert torch.equal(p, q), name
    bf16 = pw.load_safetensors_dir(ckpt, got_cfg, device="cpu")
    want = jw.load_safetensors_dir(ckpt, want_cfg)
    np.testing.assert_array_equal(
        bf16.decoder.layers[1].encoder_attn.k_proj.weight.float().numpy(),
        np.asarray(want["decoder"]["layers"]["xk_w"][1].astype(jnp.float32)).T)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pw.load_safetensors_dir(ckpt, got_cfg)


def test_checkpoint_writer_round_trip(tiny, tmp_path):
    """``save_whisper_checkpoint`` writes what the port loads back bit for
    bit and what JAX's loader and transformers read as the same weights."""
    cfg, hf, params, model = tiny
    path = str(tmp_path / "written")
    save_whisper_checkpoint(model, cfg, path)
    read_cfg = pw.config_from_hf_json(path)
    assert (read_cfg.d_model, read_cfg.vocab_size, read_cfg.eos_token_id) == \
        (cfg.d_model, cfg.vocab_size, cfg.eos_token_id)
    back = pw.load_safetensors_dir(path, read_cfg, device="cpu", dtype=torch.float32)
    for (name, p), (_, q) in zip(back.named_parameters(), model.named_parameters()):
        assert torch.equal(p, q), name
    jparams = jw.load_safetensors_dir(path, jw.config_from_hf_json(path), dtype=jnp.float32)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    loaded = transformers.WhisperForConditionalGeneration.from_pretrained(path)
    want = hf.state_dict()
    for name, t in loaded.state_dict().items():
        assert torch.equal(t, want[name]), name


def test_node_worker_shard_and_corpus_match_jax(tmp_path):
    for n, workers, nodes in ((10, 3, 1), (17, 2, 3), (5, 4, 2)):
        for node in range(nodes):
            for w in range(workers):
                assert asr.node_worker_shard(n, worker=w, num_workers=workers, node=node,
                                             num_nodes=nodes) == jasr.node_worker_shard(
                    n, worker=w, num_workers=workers, node=node, num_nodes=nodes)
    calls = []

    def transcriber(path):
        calls.append(path)
        return [(0.0, 0.5, os.path.basename(path)), (0.5, 1.0, "x")]

    videos = [f"/data/v{i}.mp4" for i in range(5)]
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    got = asr.transcribe_corpus(videos, transcriber, out_p, worker=1, num_workers=2, node=0)
    want = jasr.transcribe_corpus(videos, transcriber, out_j, worker=1, num_workers=2, node=0)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        with open(a) as fa, open(b) as fb:
            assert json.load(fa) == json.load(fb)
    n_calls = len(calls)
    assert asr.transcribe_corpus(videos, transcriber, out_p, worker=1, num_workers=2,
                                 node=0) == got
    assert len(calls) == n_calls                 # idempotent: existing files are kept


def small_mel(orig, frames):
    def run(seg, num_mel_filters):
        out = orig(seg, num_mel_filters=num_mel_filters, pad_to_chunk=False)
        return out[:, :frames]
    return run


def test_transcriber_words_identical_to_jax(tiny, tmp_path, monkeypatch):
    """One WAV of 2.5 s in segments of 1 s through both transcribers on the
    same bf16-rounded weights computed in fp32: identical word triples. The
    tiny model takes a mel of 2 * max_source_positions frames, so both
    packages' frontends are cut to that (as JAX's own test does)."""
    if not (jvr.is_available() and vr.is_available()):
        pytest.skip("native decoder unavailable")
    cfg, hf, _, _ = tiny
    ckpt = str(tmp_path / "whisper_tiny")
    hf.save_pretrained(ckpt, safe_serialization=True)
    rng = np.random.RandomState(0)
    samples = (rng.randn(40000) * 0.1).astype(np.float32)
    wav_p, wav_j = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    vr.encode_test_audio(wav_p, samples, 16000)
    jvr.encode_test_audio(wav_j, samples, 16000)
    with open(wav_p, "rb") as a, open(wav_j, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(vr.load_audio(wav_p), jvr.load_audio(wav_p))

    import livecc_tpu.audio.mel as jax_mel_mod

    monkeypatch.setattr(jax_mel_mod, "log_mel_spectrogram",
                        small_mel(jax_mel_mod.log_mel_spectrogram, 2 * cfg.max_source_positions))
    monkeypatch.setattr(mel, "log_mel_spectrogram",
                        small_mel(mel.log_mel_spectrogram, 2 * cfg.max_source_positions))
    decode = lambda ids: " ".join(f"w{i}" for i in ids)
    jtr = jasr.WhisperTranscriber(ckpt, chunk_seconds=1, decode_text=decode)
    jtr.params = jax.tree.map(lambda x: x.astype(jnp.float32), jtr.params)
    ptr = asr.WhisperTranscriber(ckpt, chunk_seconds=1, decode_text=decode, device="cpu")
    ptr.model.float()
    want = jtr(wav_p)
    got = ptr(wav_p)
    assert got == want and len(got) > 0
    assert {w[0] // 1 for w in got} == {0.0, 1.0, 2.0}        # words in all 3 segments
    # a plugged-in loader takes the place of the decoder
    fed = asr.WhisperTranscriber(ckpt, chunk_seconds=1, decode_text=decode, device="cpu",
                                 audio_loader=lambda path, sr: vr.load_audio(wav_p, sr))
    fed.model.float()
    assert fed("anything.mp4") == got


def test_video_with_audio_round_trip(tmp_path):
    """``encode_video_with_audio`` muxes an AAC track that both packages'
    ``load_audio`` read back alike, about as long as what was written."""
    if not (jvr.is_available() and vr.is_available()):
        pytest.skip("native decoder unavailable")
    frames = np.random.RandomState(0).randint(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    tone = np.sin(np.arange(16000) * 2 * np.pi * 440 / 16000).astype(np.float32) * 0.3
    path = str(tmp_path / "av.mp4")
    vr.encode_video_with_audio(path, frames, 8, tone, 16000)
    got = vr.load_audio(path)
    np.testing.assert_array_equal(got, jvr.load_audio(path))
    assert abs(len(got) - len(tone)) < 2048
    assert len(vr.VideoReader(path)) == 8
    with pytest.raises(IOError):
        vr.load_audio(str(tmp_path / "missing.wav"))

"""Word-timestamped ASR stage for SFT data (WhisperX pipeline structure).

Port of ``livecc_tpu/tools/asr.py``. Reference:
data/production/distributed_whisperx.py — faster-whisper large-v3-turbo
with word timestamps (:7-23), audio via decord AudioReader, node(ARNOLD_ID)
x worker x chunk sharding (:40-63). The default transcriber is the port's
Whisper (``models/whisper``) over the native audio decoder and the log-mel
frontend; word timestamps come from uniform division within each decoded
segment — the same approximation the reference's pretrain pipeline applies
to YT-CC subtitles (data/production/pretrain_to_clips.py:15-30). Any
callable with the same signature can be plugged in instead.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

Word = tuple[float, float, str]

# transcribe(audio_path_or_video_path) -> [(start, end, word), ...]
Transcriber = Callable[[str], list[Word]]


class WhisperTranscriber:
    """Segment-level greedy Whisper transcription -> word triples.

    ``checkpoint_dir`` holds an HF Whisper checkpoint (config.json +
    safetensors + tokenizer.json), loaded onto ``device`` in ``dtype`` (bf16
    by default, as JAX's ``load_safetensors_dir``); "cuda" raises without a
    card. ``decode_text`` maps token ids to text — by default tokenizers'
    Tokenizer over tokenizer.json. ``audio_loader(path, sample_rate)``
    returns mono float32 PCM; by default the native decoder's
    ``load_audio`` (which needs the FFmpeg development libraries).
    """

    def __init__(self, checkpoint_dir: str, *, chunk_seconds: int = 30,
                 decode_text: Callable[[list[int]], str] | None = None,
                 audio_loader: Callable[[str, int], np.ndarray] | None = None,
                 device="cuda", dtype: torch.dtype = torch.bfloat16):
        from livecc_tpu_torch.models.whisper import config_from_hf_json, load_safetensors_dir

        self.cfg = config_from_hf_json(checkpoint_dir)
        self.model = load_safetensors_dir(checkpoint_dir, self.cfg, device=device, dtype=dtype)
        self.chunk_seconds = chunk_seconds
        if decode_text is None:
            from livecc_tpu_torch.data.tokenizer import HFTokenizer
            tok = HFTokenizer(checkpoint_dir)
            decode_text = lambda ids: tok.decode(ids, skip_special_tokens=True)
        self.decode_text = decode_text
        if audio_loader is None:
            from livecc_tpu_torch.vision_io.video_reader import load_audio
            audio_loader = load_audio
        self.audio_loader = audio_loader

    def __call__(self, media_path: str) -> list[Word]:
        from livecc_tpu_torch.audio import mel as mel_mod
        from livecc_tpu_torch.models.whisper import greedy_transcribe_tokens

        sr = mel_mod.SAMPLE_RATE
        audio = self.audio_loader(media_path, sr)
        span = self.chunk_seconds * sr
        words: list[Word] = []
        prompt = [self.cfg.decoder_start_token_id]
        for start in range(0, max(len(audio), 1), span):
            seg = audio[start:start + span]
            if not len(seg):
                break
            mel = mel_mod.log_mel_spectrogram(seg, num_mel_filters=self.cfg.num_mel_bins)
            tokens = greedy_transcribe_tokens(self.model, self.cfg, mel, prompt)
            text = self.decode_text(
                [t for t in tokens if t < self.cfg.timestamp_begin]
            ).strip()
            if not text:
                continue
            t0 = start / sr
            t1 = min(start + len(seg), len(audio)) / sr
            # uniform word timing within the segment (pretrain_to_clips.py:15-30)
            pieces = text.split()
            step = (t1 - t0) / max(len(pieces), 1)
            words += [(t0 + i * step, t0 + (i + 1) * step, w)
                      for i, w in enumerate(pieces)]
        return words


def node_worker_shard(
    n_items: int,
    *,
    worker: int,
    num_workers: int,
    node: Optional[int] = None,
    num_nodes: int = 1,
) -> list[int]:
    """Two-level sharding: contiguous node chunks, strided workers within
    (distributed_whisperx.py:40-63 semantics). ``node`` defaults to the
    ARNOLD_ID env var the reference uses."""
    if node is None:
        node = int(os.environ.get("ARNOLD_ID", 0))
    per_node = (n_items + num_nodes - 1) // num_nodes
    lo = node * per_node
    hi = min(lo + per_node, n_items)
    return list(range(lo + worker, hi, num_workers))


def transcribe_corpus(
    video_paths: Sequence[str],
    transcriber: Transcriber,
    output_dir: str,
    *,
    worker: int = 0,
    num_workers: int = 1,
    node: Optional[int] = None,
    num_nodes: int = 1,
) -> list[str]:
    """Run ASR over a shard of videos; one JSON per video (idempotent)."""
    os.makedirs(output_dir, exist_ok=True)
    done = []
    for i in node_worker_shard(len(video_paths), worker=worker, num_workers=num_workers,
                               node=node, num_nodes=num_nodes):
        path = video_paths[i]
        out = os.path.join(output_dir, os.path.basename(path) + ".words.json")
        if not os.path.exists(out):
            words = transcriber(path)
            with open(out, "w") as f:
                json.dump([[ws, we, w] for ws, we, w in words], f)
        done.append(out)
    return done

"""Whisper log-mel frontend (numpy): STFT + slaney mel filter bank.

A copy of ``livecc_tpu/audio/mel.py``: host code in both packages, kept in
numpy so that its features are bit-equal to the JAX package's.

Behavioral contract: transformers WhisperFeatureExtractor (what the
reference's faster-whisper pipeline feeds its encoder,
data/production/distributed_whisperx.py:7-23) — hann window 400, hop 160,
201 frequency bins, slaney-scale slaney-normalized mel filters, log10 with
an 8-dB dynamic-range floor, (x + 4) / 4 scaling, 30 s zero-padding and the
trailing frame dropped. Parity-tested against the transformers extractor.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_SECONDS = 30
CHUNK_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS


def _hertz_to_mel(freq):
    """Slaney mel scale: linear below 1 kHz, log above."""
    freq = np.asarray(freq, np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(freq >= min_log_hertz,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hertz) * logstep,
                    mels)


def _mel_to_hertz(mels):
    mels = np.asarray(mels, np.float64)
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(mels >= min_log_mel,
                    1000.0 * np.exp(logstep * (mels - min_log_mel)), freq)


def mel_filter_bank(
    num_frequency_bins: int = 1 + N_FFT // 2,
    num_mel_filters: int = 128,
    min_frequency: float = 0.0,
    max_frequency: float = 8000.0,
    sampling_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """[num_frequency_bins, num_mel_filters] slaney-normalized triangles."""
    mel_min = _hertz_to_mel(min_frequency)
    mel_max = _hertz_to_mel(max_frequency)
    mel_freqs = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = _mel_to_hertz(mel_freqs)
    fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)

    filter_diff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]      # [F, M+2]
    down = -slopes[:, :-2] / filter_diff[None, :-1]
    up = slopes[:, 2:] / filter_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))               # [F, M]
    enorm = 2.0 / (filter_freqs[2:] - filter_freqs[:-2])     # slaney norm
    return (fb * enorm[None, :]).astype(np.float64)


def log_mel_spectrogram(
    audio: np.ndarray,
    num_mel_filters: int = 128,
    *,
    pad_to_chunk: bool = True,
) -> np.ndarray:
    """mono float [T] -> [num_mel_filters, frames] Whisper-scaled log-mel."""
    audio = np.asarray(audio, np.float64)
    if pad_to_chunk:
        if len(audio) > CHUNK_SAMPLES:
            audio = audio[:CHUNK_SAMPLES]
        audio = np.pad(audio, (0, CHUNK_SAMPLES - len(audio)))
    # centered STFT, reflect padding, hann window (periodic form via the
    # sin^2 identity the extractor uses: hann(N) of length n_fft)
    window = np.hanning(N_FFT + 1)[:-1]
    audio = np.pad(audio, (N_FFT // 2, N_FFT // 2), mode="reflect")
    n_frames = 1 + (len(audio) - N_FFT) // HOP_LENGTH
    idx = np.arange(N_FFT)[None, :] + HOP_LENGTH * np.arange(n_frames)[:, None]
    frames = audio[idx] * window[None, :]
    stft = np.fft.rfft(frames, n=N_FFT, axis=1)              # [frames, F]
    magnitudes = np.abs(stft[:-1]) ** 2                      # drop last frame
    fb = mel_filter_bank(num_mel_filters=num_mel_filters)
    mel = magnitudes @ fb                                    # [frames, M]
    log_spec = np.log10(np.clip(mel, 1e-10, None))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.T.astype(np.float32)                     # [M, frames]

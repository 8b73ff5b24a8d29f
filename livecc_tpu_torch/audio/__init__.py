from livecc_tpu_torch.audio.mel import log_mel_spectrogram, mel_filter_bank

__all__ = ["log_mel_spectrogram", "mel_filter_bank"]

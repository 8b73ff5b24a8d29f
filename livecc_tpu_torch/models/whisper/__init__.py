from livecc_tpu_torch.models.whisper.bridge import whisper_params_from_jax
from livecc_tpu_torch.models.whisper.convert import (
    config_from_hf_json, convert_state_dict, convert_torch_model, load_safetensors_dir,
)
from livecc_tpu_torch.models.whisper.model import (
    Whisper, WhisperConfig, greedy_transcribe_tokens, init_whisper, tiny_whisper_config,
    whisper_decode, whisper_encode,
)

__all__ = [
    "Whisper", "WhisperConfig", "config_from_hf_json", "convert_state_dict",
    "convert_torch_model", "greedy_transcribe_tokens", "init_whisper", "load_safetensors_dir",
    "tiny_whisper_config", "whisper_decode", "whisper_encode", "whisper_params_from_jax",
]

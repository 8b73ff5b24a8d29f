"""HF Whisper checkpoint -> the port's ``Whisper`` module.

Port of ``livecc_tpu/models/whisper/convert.py``. The port's modules carry
HF's names below ``model.`` and keep its layouts (``nn.Linear``'s ``[out,
in]``, ``nn.Conv1d``'s ``[out, in, k]``), so a state dict loads with the
prefix stripped and no tensor transposed (JAX transposes to ``[in, out]``
and ``[k, in, out]``). ``proj_out.weight``, HF's copy of the tied decoder
embedding, has no parameter of its own and is skipped, as JAX skips it.

``convert_state_dict`` builds the model on the ``meta`` device, gives it
empty storage on the target device and fills every parameter once, its
shape checked; ``load_safetensors_dir`` does so from the shards of a
checkpoint directory through ``models/qwen2_vl/safetensors_io.Shards``
(which follows the index and reads bf16 without ``ml_dtypes``). A value is
cast with ``copy_``: fp32 -> bf16 rounds to nearest even, as
``jnp.asarray(..., bfloat16)`` does.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import torch

from livecc_tpu_torch.models.qwen2_vl.safetensors_io import Shards
from livecc_tpu_torch.models.whisper.model import Whisper, WhisperConfig
from livecc_tpu_torch.utils.device import device_for

TIED_HEAD = "proj_out.weight"


@torch.no_grad()
def convert_state_dict(state: Mapping[str, Any], cfg: WhisperConfig, device=None,
                       dtype: torch.dtype = torch.float32) -> Whisper:
    """A ``Whisper`` on ``device`` in ``dtype`` holding an HF
    WhisperForConditionalGeneration state dict (numpy arrays or tensors).
    Every parameter must be in ``state`` (KeyError) with its shape
    (ValueError)."""
    keys = {k.removeprefix("model."): k for k in state if k != TIED_HEAD}
    model = Whisper(cfg, device="meta", dtype=dtype).to_empty(device=device or "cpu")
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(keys))
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensors the model needs: {missing[:8]}")
    for name, p in params.items():
        src = torch.as_tensor(state[keys[name]])
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: checkpoint has shape {tuple(src.shape)}, the model "
                             f"{tuple(p.shape)}")
        p.copy_(src)
    return model


def convert_torch_model(model, cfg: WhisperConfig, device=None,
                        dtype: torch.dtype = torch.float32) -> Whisper:
    """The port's model on the weights of an in-memory HF model (tests)."""
    return convert_state_dict(model.state_dict(), cfg, device, dtype)


def config_from_hf_json(path: str) -> WhisperConfig:
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    return WhisperConfig(
        num_mel_bins=hf["num_mel_bins"],
        d_model=hf["d_model"],
        encoder_layers=hf["encoder_layers"],
        decoder_layers=hf["decoder_layers"],
        num_heads=hf["encoder_attention_heads"],
        ffn_dim=hf["encoder_ffn_dim"],
        vocab_size=hf["vocab_size"],
        max_source_positions=hf.get("max_source_positions", 1500),
        max_target_positions=hf.get("max_target_positions", 448),
        decoder_start_token_id=hf.get("decoder_start_token_id", 50258),
        eos_token_id=hf.get("eos_token_id", 50257),
    )


def load_safetensors_dir(path: str, cfg: WhisperConfig, device="cuda",
                         dtype: torch.dtype = torch.bfloat16) -> Whisper:
    """The model of a checkpoint directory's shards, loaded onto ``device``
    in ``dtype`` (bf16 by default, as JAX's) one tensor at a time; "cuda"
    raises without a card."""
    device_for(device, "load_safetensors_dir")
    with Shards(path) as shards:
        return convert_state_dict(shards, cfg, device=device, dtype=dtype)

"""Write a port model as an HF checkpoint directory (safetensors shards).

``chip_smoke.py`` writes the 7B it drew on the card this way and loads it
back through ``models/qwen2_vl/convert.py:load_checkpoint``; the tests hold
the files to the ``safetensors`` package's reader. Tensor names are the
transformers>=4.52 ones (``model.visual.*``, ``model.language_model.*``,
``lm_head.weight``), in the model's dtype; the patch embed is written in
HF's Conv3d shape. Shards of about ``shard_bytes`` come with a
``model.safetensors.index.json``. This is not on the load path.

``save_whisper_checkpoint`` writes the port's Whisper the same way (one
shard, HF's names), for ``chip_smoke.py``'s ``asr`` phase to load back
through ``tools/asr.py:WhisperTranscriber``.
"""

from __future__ import annotations

import json
import os
import shutil
import struct

import torch

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.models.qwen2_vl.convert import PATCH_EMBED, hf_name_map
from livecc_tpu_torch.models.qwen2_vl.model import Qwen2VL
from livecc_tpu_torch.models.qwen2_vl.safetensors_io import DTYPES, INDEX_FILE
from livecc_tpu_torch.models.whisper.model import Whisper, WhisperConfig

DTYPE_NAMES = {dt: name for name, dt in DTYPES.items()}


def hf_key(canonical: str) -> str:
    """A canonical name (``convert._canonicalize``'s) in the >=4.52 era."""
    if canonical.startswith("visual."):
        return "model." + canonical
    if canonical.startswith("llm."):
        return "model.language_model." + canonical[len("llm."):]
    return canonical


def _write_shard(file: str, tensors: list[tuple[str, torch.Tensor]]) -> None:
    header, at = {}, 0
    for name, t in tensors:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + n]}
        at += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)          # data starts 8-byte aligned
    with open(file, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in tensors:
            f.write(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().data)


@torch.no_grad()
def save_checkpoint(model: Qwen2VL, cfg: ModelConfig, path: str, config_json: str,
                    shard_bytes: int = 5 * 10**9) -> list[str]:
    """Write ``model`` into the new directory ``path`` with ``config_json``
    copied to ``config.json``; returns the shard files. One tensor on the
    host at a time."""
    os.makedirs(path)
    shutil.copy(config_json, os.path.join(path, "config.json"))
    params = dict(model.named_parameters())
    shards: list[list[tuple[str, str]]] = [[]]
    size = 0
    for name, canonical in hf_name_map(cfg).items():
        n = params[name].numel() * params[name].element_size()
        if shards[-1] and size + n > shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append((name, hf_key(canonical)))
        size += n
    files, weight_map = [], {}
    for i, shard in enumerate(shards):
        file = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        tensors = []
        for name, key in shard:
            t = params[name]
            if name == PATCH_EMBED:
                v = cfg.vision
                t = t.reshape(v.embed_dim, v.in_channels, v.temporal_patch_size,
                              v.patch_size, v.patch_size)
            tensors.append((key, t))
            weight_map[key] = file
        _write_shard(os.path.join(path, file), tensors)
        files.append(os.path.join(path, file))
    total = sum(p.numel() * p.element_size() for p in params.values())
    with open(os.path.join(path, INDEX_FILE), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=1)
    return files


@torch.no_grad()
def save_whisper_checkpoint(model: Whisper, cfg: WhisperConfig, path: str) -> str:
    """Write ``model`` into the new directory ``path`` as an HF Whisper
    checkpoint: ``model.safetensors`` with HF's names (``model.`` + the
    port's; no ``proj_out.weight``, which HF ties to the decoder embedding)
    in the model's dtype, and a ``config.json`` that transformers and
    ``models/whisper/convert.py:config_from_hf_json`` read. Returns the
    shard. One tensor on the host at a time."""
    os.makedirs(path)
    config = {
        "architectures": ["WhisperForConditionalGeneration"], "model_type": "whisper",
        "num_mel_bins": cfg.num_mel_bins, "d_model": cfg.d_model,
        "encoder_layers": cfg.encoder_layers, "decoder_layers": cfg.decoder_layers,
        "encoder_attention_heads": cfg.num_heads, "decoder_attention_heads": cfg.num_heads,
        "encoder_ffn_dim": cfg.ffn_dim, "decoder_ffn_dim": cfg.ffn_dim,
        "vocab_size": cfg.vocab_size, "max_source_positions": cfg.max_source_positions,
        "max_target_positions": cfg.max_target_positions,
        "decoder_start_token_id": cfg.decoder_start_token_id,
        # HF's Whisper configs set bos and pad to <|endoftext|> as well
        "eos_token_id": cfg.eos_token_id, "bos_token_id": cfg.eos_token_id,
        "pad_token_id": cfg.eos_token_id, "tie_word_embeddings": True,
        "torch_dtype": str(next(model.parameters()).dtype).removeprefix("torch."),
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    file = os.path.join(path, "model.safetensors")
    _write_shard(file, [("model." + name, p) for name, p in model.named_parameters()])
    return file

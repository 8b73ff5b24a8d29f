"""The port's checkpoint loader against the JAX package's, on the CPU.

``convert_state_dict``, ``load_checkpoint`` (safetensors shards, read tensor
by tensor without the ``safetensors`` package) and ``config_from_hf_json`` of
``livecc_tpu_torch/models/qwen2_vl/convert.py`` against JAX
``convert_state_dict`` / ``load_safetensors_dir`` followed by
``params_from_jax``, and against ``config_from_hf_json``. Weights: the
hf_tiny goldens (HF names of the >=4.52 era); shards written by the
``safetensors`` package. fp32 comparisons are exact; the loaded model's
logits are held to HF's golden ``mm_logits`` within 1e-4, the tolerance of
``tests/test_torch_model.py``.
"""

import dataclasses
import json
import os
import shutil
import struct
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from safetensors.numpy import save_file as save_numpy
from safetensors.torch import save_file as save_torch

from livecc_tpu.core import config as jcfg
from livecc_tpu.models.qwen2_vl import convert as jconvert

from livecc_tpu_torch.core.config import ModelConfig, tiny_config
from livecc_tpu_torch.models import qwen2_vl as pm
from livecc_tpu_torch.models.qwen2_vl import convert, safetensors_io
from livecc_tpu_torch.models.qwen2_vl.bridge import params_from_jax
from livecc_tpu_torch.ops.rope import vision_rotary_cos_sin
from livecc_tpu_torch.tools.checkpoint import save_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def golden(name="hf_tiny"):
    g = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    state = {k[len("state::"):]: g[k] for k in g.files if k.startswith("state::")}
    return g, state


def tied(cfg):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, tie_word_embeddings=True))


def to_hub_era(state):
    return {k.replace("model.visual.", "visual.").replace("model.language_model.", "model."): v
            for k, v in state.items()}


def jax_model(state, jax_cfg, port_cfg, dtype=jnp.float32, torch_dtype=torch.float32):
    tree = jax.tree_util.tree_map(np.asarray, jconvert.convert_state_dict(state, jax_cfg, dtype))
    return params_from_jax(tree, port_cfg, dtype=torch_dtype)


def assert_same(a, b):
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert pa.keys() == pb.keys()
    for n in pa:
        assert pa[n].dtype == pb[n].dtype and torch.equal(pa[n], pb[n]), n


def tiny_config_json(path, layout="top"):
    """A config.json whose shapes and token ids are tiny_config's."""
    cfg = tiny_config()
    t, v = cfg.text, cfg.vision
    text = dict(vocab_size=t.vocab_size, hidden_size=t.hidden_size,
                intermediate_size=t.intermediate_size, num_hidden_layers=t.num_hidden_layers,
                num_attention_heads=t.num_attention_heads,
                num_key_value_heads=t.num_key_value_heads,
                rope_scaling={"type": "mrope", "mrope_section": list(t.mrope_section)})
    full = dict(vision_config=dict(depth=v.depth, embed_dim=v.embed_dim, num_heads=v.num_heads,
                                   hidden_size=v.hidden_size),
                bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id,
                vision_start_token_id=cfg.vision_start_token_id,
                vision_end_token_id=cfg.vision_end_token_id,
                image_token_id=cfg.image_token_id, video_token_id=cfg.video_token_id)
    full.update(text if layout == "top" else {"text_config": text})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(full, f)


def write_two_shards(path, state, save=save_numpy):
    """``state`` as two shards with an index, as HF's ``save_pretrained`` lays them out."""
    os.makedirs(path, exist_ok=True)
    keys = sorted(state)
    halves = {"model-00001-of-00002.safetensors": keys[: len(keys) // 2],
              "model-00002-of-00002.safetensors": keys[len(keys) // 2:]}
    weight_map = {}
    for file, names in halves.items():
        save({k: state[k] for k in names}, os.path.join(path, file))
        weight_map.update({k: file for k in names})
    with open(os.path.join(path, safetensors_io.INDEX_FILE), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    tiny_config_json(path)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny")
    write_two_shards(path, golden()[1])
    return path


def test_both_naming_eras_give_identical_modules():
    _, state = golden()
    hub = to_hub_era(state)
    assert any(k.startswith("visual.") for k in hub) and any(k.startswith("model.layers.") for k in hub)
    assert_same(convert.convert_state_dict(state, tiny_config()),
                convert.convert_state_dict(hub, tiny_config()))


@pytest.mark.parametrize("name", ["hf_tiny", "hf_tiny_tied"])
def test_convert_state_dict_matches_jax(name):
    _, state = golden(name)
    jax_cfg, cfg = jcfg.tiny_config(), tiny_config()
    if name.endswith("tied"):
        jax_cfg, cfg = tied(jax_cfg), tied(cfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model = convert.convert_state_dict(state, cfg)
    # beside tied embeddings lm_head.weight is reported and skipped, as JAX skips it
    reported = [str(w.message) for w in caught if "skipped" in str(w.message)]
    assert reported == (["convert_state_dict: skipped 1 checkpoint tensors the model has no "
                         "parameter for: ['lm_head.weight']"] if cfg.text.tie_word_embeddings
                        else [])
    assert (model.text.lm_head is None) == cfg.text.tie_word_embeddings
    assert_same(model, jax_model(state, jax_cfg, cfg))


def test_load_checkpoint_matches_jax_load_safetensors_dir(shards):
    assert len(safetensors_io.shard_files(shards)) == 2
    cfg, model = convert.load_checkpoint(shards, "cpu", torch.float32)
    assert cfg.text == tiny_config().text and cfg.vision == tiny_config().vision
    tree = jax.tree_util.tree_map(
        np.asarray, jconvert.load_safetensors_dir(shards, jcfg.tiny_config(), dtype=jnp.float32))
    assert_same(model, params_from_jax(tree, tiny_config()))
    assert not any(p.is_meta for p in model.parameters())
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_bf16_checkpoint_loads_bit_equal(tmp_path):
    """bf16 shards load bit-equal; an fp32 checkpoint loaded into bf16
    rounds to nearest even, as JAX's ``jnp.asarray(..., bfloat16)``."""
    _, state = golden()
    bf16 = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in state.items()}
    write_two_shards(str(tmp_path / "bf16"), bf16, save=save_torch)
    _, model = convert.load_checkpoint(str(tmp_path / "bf16"), "cpu", torch.bfloat16)
    names = convert.hf_name_map(tiny_config())
    keys = {convert._canonicalize(k): k for k in bf16}
    for name, p in model.named_parameters():
        src = bf16[keys[names[name]]]
        assert p.dtype == torch.bfloat16 and torch.equal(p, src.reshape(p.shape)), name

    write_two_shards(str(tmp_path / "fp32"), state)
    _, model = convert.load_checkpoint(str(tmp_path / "fp32"), "cpu", torch.bfloat16)
    assert_same(model, jax_model(state, jcfg.tiny_config(), tiny_config(), jnp.bfloat16,
                                 torch.bfloat16))


def test_loaded_model_logits_match_hf_golden(shards):
    g, _ = golden()
    cfg, model = convert.load_checkpoint(shards, "cpu", torch.float32)
    ids, grid = g["mm_ids"], [tuple(int(x) for x in g["mm_grid"][0])]
    pos, _ = pm.get_rope_index(cfg, ids, video_grid_thw=np.asarray(grid))
    cos, sin = vision_rotary_cos_sin(grid, cfg.vision.head_dim)
    t, h, w = grid[0]
    seg = np.repeat(np.arange(t), h * w).astype(np.int32)
    vision = pm.VisionInputs(torch.from_numpy(g["mm_patches"]), torch.from_numpy(cos),
                             torch.from_numpy(sin), torch.from_numpy(seg), h * w)
    logits, _ = pm.forward(model, cfg, torch.from_numpy(ids), torch.from_numpy(pos),
                           pm.KVCache.zeros(cfg.text, 1, 64), vision=vision)
    np.testing.assert_allclose(logits.numpy(), g["mm_logits"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("variant", ["7b", "2b_tied"])
@pytest.mark.parametrize("layout", ["top", "nested"])
def test_config_from_hf_json_matches_jax(tmp_path, variant, layout):
    with open(os.path.join(FIXTURES, "qwen2_vl_7b_config.json")) as f:
        hf = json.load(f)
    ref = ModelConfig.qwen2_vl_7b()
    if variant == "2b_tied":
        hf.update(vocab_size=151936, hidden_size=1536, intermediate_size=8960,
                  num_attention_heads=12, num_key_value_heads=2, tie_word_embeddings=True)
        hf["vision_config"]["hidden_size"] = 1536
        ref = ModelConfig.qwen2_vl_2b()
    if layout == "nested":
        keep = {"vision_config", "bos_token_id", "eos_token_id", "vision_start_token_id",
                "vision_end_token_id", "image_token_id", "video_token_id"}
        hf = {**{k: v for k, v in hf.items() if k in keep},
              "text_config": {k: v for k, v in hf.items() if k not in keep}}
    with open(tmp_path / "config.json", "w") as f:
        json.dump(hf, f)
    cfg = convert.config_from_hf_json(str(tmp_path))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jconvert.config_from_hf_json(str(tmp_path)))
    assert cfg.text == ref.text and cfg.vision == ref.vision
    for f in ("bos_token_id", "eos_token_id", "vision_start_token_id", "vision_end_token_id",
              "image_token_id", "video_token_id"):
        assert getattr(cfg, f) == getattr(ref, f), f


def test_missing_parameter_raises():
    _, state = golden()
    del state["model.language_model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="layers.1.mlp.up_proj.weight"):
        convert.convert_state_dict(state, tiny_config())


def test_wrong_shape_and_duplicate_names_raise():
    _, state = golden()
    bad = dict(state)
    bad["model.visual.blocks.0.attn.qkv.bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="qkv.bias"):
        convert.convert_state_dict(bad, tiny_config())
    both = {**state, **to_hub_era(state)}
    with pytest.raises(ValueError, match="name one tensor"):
        convert.convert_state_dict(both, tiny_config())


def test_reader_rejects_unknown_dtype_and_a_wrong_index(tmp_path):
    raw = json.dumps({"x": {"dtype": "F8_E5M2", "shape": [2], "data_offsets": [0, 2]}}).encode()
    (tmp_path / "a.safetensors").write_bytes(struct.pack("<Q", len(raw)) + raw + b"\0\0")
    with pytest.raises(TypeError, match="F8_E5M2"):
        safetensors_io.Shards(str(tmp_path))
    other = tmp_path / "idx"
    other.mkdir()
    save_numpy({"x": np.ones(3, np.float32)}, str(other / "a.safetensors"))
    with open(other / safetensors_io.INDEX_FILE, "w") as f:
        json.dump({"weight_map": {"x": "a.safetensors", "y": "a.safetensors"}}, f)
    with pytest.raises(ValueError, match="no shard holds"):
        safetensors_io.Shards(str(other))


def test_reader_serves_every_dtype(tmp_path):
    tensors = {"bf16": torch.randn(3, 4).to(torch.bfloat16), "f16": torch.randn(5).half(),
               "f32": torch.randn(2, 2, 2), "i8": torch.arange(-4, 4, dtype=torch.int8),
               "u8": torch.arange(6, dtype=torch.uint8), "i16": torch.arange(3, dtype=torch.int16),
               "i32": torch.arange(7, dtype=torch.int32), "i64": torch.arange(2, dtype=torch.int64),
               "bool": torch.tensor([True, False, True])}
    save_torch(tensors, str(tmp_path / "all.safetensors"))
    with safetensors_io.Shards(str(tmp_path)) as shards:
        assert set(shards) == set(tensors)
        for k, v in tensors.items():
            a, b = shards[k], shards[k]
            assert a.dtype == v.dtype and torch.equal(a, v) and torch.equal(b, v), k
            assert a.data_ptr() != b.data_ptr()       # each lookup reads into its own tensor


def test_port_writer_reads_back_through_the_safetensors_package(tmp_path):
    """``tools/checkpoint.py`` (chip_smoke's writer): >=4.52 names, sharded
    with an index, read by JAX ``load_safetensors_dir`` and by the port."""
    model = pm.init_params(tiny_config(), torch.Generator().manual_seed(3), "cpu", torch.float32)
    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    tiny_config_json(str(cfg_dir), layout="nested")
    path = str(tmp_path / "written")
    files = save_checkpoint(model, tiny_config(), path, str(cfg_dir / "config.json"),
                            shard_bytes=300_000)
    assert len(files) > 2
    tree = jax.tree_util.tree_map(
        np.asarray, jconvert.load_safetensors_dir(path, jcfg.tiny_config(), dtype=jnp.float32))
    assert_same(model, params_from_jax(tree, tiny_config()))
    cfg, loaded = convert.load_checkpoint(path, "cpu", torch.float32)
    assert cfg.text == tiny_config().text
    assert_same(model, loaded)
    shutil.rmtree(path)

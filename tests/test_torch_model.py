"""The port's model against the JAX package's, on the same weights and inputs.

Weights are JAX param trees (``init_params`` from a seed, or the hf_tiny
golden through ``convert_state_dict``) carried across by
``params_from_jax``; inputs are numpy arrays from a seed. fp32 on the CPU;
the JAX ViT runs its Pallas kernel in interpret mode, the JAX text tower its
plain reference path. Tolerances: 1e-5 for activations, 1e-4 for logits.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.data import chat
from livecc_tpu.data.tokenizer import ByteTokenizer
from livecc_tpu.models import qwen2_vl as jm
from livecc_tpu.vision_io.patchify import device_patchify as jax_device_patchify

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.models import qwen2_vl as pm
from livecc_tpu_torch.ops.rope import vision_rotary_cos_sin
from livecc_tpu_torch.vision_io.patchify import device_patchify, grid_for_frames
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "hf_tiny.npz")
T = torch.from_numpy


def close(port, ref, atol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=0)


@pytest.fixture(scope="module")
def seeded():
    """(JAX params, port model) from one JAX init at the tiny config."""
    params = jm.init_params(jax_tiny_config(), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return params, pm.params_from_jax(tree, tiny_config())


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    state = {k[len("state::"):]: g[k] for k in g.files if k.startswith("state::")}
    params = jm.convert_state_dict(state, jax_tiny_config())
    tree = jax.tree_util.tree_map(np.asarray, params)
    return params, pm.params_from_jax(tree, tiny_config())


def frames(n, seed=0, h=56, w=28):
    return np.random.RandomState(seed).randint(0, 256, size=(n, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("t", [6, 5])
def test_device_patchify(t):
    f = frames(t)
    out = device_patchify(T(f))
    ref = jax_device_patchify(jnp.asarray(f))
    assert grid_for_frames(t, 56, 28, tiny_config().vision)[0] == 3
    close(out, ref, 1e-6)


@pytest.mark.parametrize("grouped", [True, False])
def test_patchify_then_vision_tower(seeded, grouped):
    """Uniform groups go to K3 (the plain version here), against JAX
    ``vision_forward(use_flash=True)`` in interpret mode; the mixed-size
    segment-mask path against its JAX counterpart."""
    params, model = seeded
    cfg = tiny_config().vision
    f = frames(6)
    grid = grid_for_frames(6, 56, 28, cfg)
    n = grid[0] * grid[1] * grid[2]
    cos, sin = vision_rotary_cos_sin([grid], cfg.head_dim)
    seg = np.repeat(np.arange(grid[0]), grid[1] * grid[2]).astype(np.int32)
    group = grid[1] * grid[2] if grouped else None
    out = model.visual(device_patchify(T(f)), T(cos), T(sin), T(seg), group)
    with pltpu.force_tpu_interpret_mode():
        ref = jm.vision_forward(params["visual"], jax_tiny_config().vision,
                                jax_device_patchify(jnp.asarray(f)), cos, sin, seg, group,
                                use_flash=grouped)
    assert out.shape == (n // 4, cfg.hidden_size)
    close(out, ref, 1e-5)


def test_cached_text_forward_prefill_then_decode(seeded):
    """One padded prefill at B = 2 (rows with different valid lengths) and
    3 decode steps; hidden states, logits and the whole cache agree."""
    params, model = seeded
    jcfg, cfg = jax_tiny_config().text, tiny_config().text
    rng = np.random.RandomState(1)
    b, s, smax = 2, 20, 64
    valid = np.asarray([17, 9], np.int32)
    emb = rng.randn(b, s, cfg.hidden_size).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None, None], (3, b, s)).astype(np.int32)

    jcache = jm.KVCache.zeros(jcfg, b, smax)
    pcache = pm.KVCache.zeros(cfg, b, smax)
    key_valid = jnp.arange(smax)[None, :] < jnp.asarray(valid)[:, None]
    jh, jcache = jm.text_forward(params["text"], jcfg, jnp.asarray(emb), jnp.asarray(pos),
                                 cache=jcache, attention_mask=key_valid)
    ph, pcache = pm.text_forward(model.text, cfg, T(emb), T(pos), pcache, kv_limit=T(valid))
    close(ph, jh, 1e-5)
    jcache = jm.KVCache(jcache.k, jcache.v, jnp.asarray(valid))
    pcache.offset = T(valid.copy())
    for step in range(3):
        e = rng.randn(b, 1, cfg.hidden_size).astype(np.float32)
        p = np.broadcast_to((valid + step)[None, :, None], (3, b, 1)).astype(np.int32)
        jh, jcache = jm.text_forward(params["text"], jcfg, jnp.asarray(e), jnp.asarray(p), cache=jcache)
        ph, pcache = pm.text_forward(model.text, cfg, T(e), T(p), pcache)
        close(pm.lm_logits(model.text, cfg, ph), jm.lm_logits(params["text"], jcfg, jh), 1e-4)
        np.testing.assert_array_equal(pcache.offset.numpy(), np.asarray(jcache.offset))
    close(pcache.k, jcache.k, 1e-5)
    close(pcache.v, jcache.v, 1e-5)


def test_full_forward_on_golden_weights(golden):
    """Text + video prompt through the whole model on the hf_tiny weights
    (JAX ``convert_state_dict`` -> ``params_from_jax``)."""
    params, model = golden
    jcfg, cfg = jax_tiny_config(), tiny_config()
    f = frames(6, seed=3)
    grid = grid_for_frames(6, 56, 28, cfg.vision)
    text = chat.render_chat([{"role": "user", "content": [
        {"type": "text", "text": "Time=0.0-3.0s"}, {"type": "video", "video": None},
        {"type": "text", "text": "describe"}]}], add_generation_prompt=True)
    ids = np.asarray([ByteTokenizer().encode(chat.expand_vision_placeholders(
        text, video_grid_thw=[grid]))], np.int32)
    pos, _ = pm.get_rope_index(cfg, ids, video_grid_thw=np.asarray([grid]))
    s, smax = ids.shape[1], 256
    cos, sin = vision_rotary_cos_sin([grid], cfg.vision.head_dim)
    seg = np.repeat(np.arange(grid[0]), grid[1] * grid[2]).astype(np.int32)
    group = grid[1] * grid[2]

    jvis = jm.VisionInputs(jax_device_patchify(jnp.asarray(f)), jnp.asarray(cos),
                           jnp.asarray(sin), jnp.asarray(seg), group)
    key_valid = jnp.arange(smax)[None, :] < s
    jlogits, _ = jm.forward(params, jcfg, jnp.asarray(ids), jnp.asarray(pos), vision=jvis,
                            cache=jm.KVCache.zeros(jcfg.text, 1, smax), attention_mask=key_valid)
    pvis = pm.VisionInputs(device_patchify(T(f)), T(cos), T(sin), T(seg), group)
    plogits, pcache = pm.forward(model, cfg, T(ids), T(pos), pm.KVCache.zeros(cfg.text, 1, smax),
                                 vision=pvis)
    assert plogits.shape == (1, s, cfg.text.vocab_size) and plogits.dtype == torch.float32
    close(plogits, jlogits, 1e-4)
    assert int(pcache.offset[0]) == s


def test_tied_embeddings_forward():
    """The 2B family ties the LM head to the embedding: the bridge carries
    no lm_head and ``lm_logits`` reads embed.T (hf_tiny_tied golden)."""
    import dataclasses

    g = np.load(os.path.join(os.path.dirname(__file__), "goldens", "hf_tiny_tied.npz"))
    jbase, pbase = jax_tiny_config(), tiny_config()
    jcfg = dataclasses.replace(jbase, text=dataclasses.replace(jbase.text, tie_word_embeddings=True))
    cfg = dataclasses.replace(pbase, text=dataclasses.replace(pbase.text, tie_word_embeddings=True))
    state = {k[len("state::"):]: g[k] for k in g.files if k.startswith("state::")}
    params = jm.convert_state_dict(state, jcfg)
    model = pm.params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg)
    assert model.text.lm_head is None
    ids = g["text_ids"]
    pos, _ = pm.get_rope_index(cfg, ids)
    smax = 64
    jlogits, _ = jm.forward(params, jcfg, jnp.asarray(ids), jnp.asarray(pos),
                            cache=jm.KVCache.zeros(jcfg.text, 1, smax),
                            attention_mask=jnp.arange(smax)[None, :] < ids.shape[1])
    plogits, _ = pm.forward(model, cfg, T(ids), T(pos), pm.KVCache.zeros(cfg.text, 1, smax))
    close(plogits, jlogits, 1e-4)
    np.testing.assert_allclose(plogits.numpy(), g["text_logits"], atol=2e-4, rtol=1e-3)


def test_lm_logits_bf16_is_never_rounded_to_bf16():
    """bf16 hidden states and weights: JAX's ``lm_logits`` returns the fp32
    product (``preferred_element_type=float32``) without rounding it to bf16;
    the port must too (a bf16 product widened afterwards is off by ~1e-2)."""
    import dataclasses

    rng = np.random.RandomState(7)
    h, v = 256, 1000
    hidden = rng.randn(1, 1, h).astype(np.float32)
    weight = (rng.randn(v, h) / np.sqrt(h)).astype(np.float32)
    jcfg = dataclasses.replace(jax_tiny_config().text, hidden_size=h, vocab_size=v)
    cfg = dataclasses.replace(tiny_config().text, hidden_size=h, vocab_size=v)
    ref = jm.lm_logits({"lm_head": {"kernel": jnp.asarray(weight.T, jnp.bfloat16)}}, jcfg,
                       jnp.asarray(hidden, jnp.bfloat16))
    model = pm.Qwen2VL(dataclasses.replace(tiny_config(), text=cfg), dtype=torch.bfloat16).text
    model.lm_head.weight.copy_(T(weight).bfloat16())
    out = pm.lm_logits(model, cfg, T(hidden).bfloat16())
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    close(out, ref, 1e-4)


def test_batched_clips_of_mixed_grids_match_jax(seeded):
    """Two rows that share a layout of two clips of different (h, w), so no
    uniform group: JAX ``vmap``s the tower per row; the port offsets each
    row's segment ids and runs K3's bounds form (the plain version here)
    over both rows at once. fp32 logits within 1e-4 of JAX's largest."""
    from livecc_tpu.data import chat

    params, model = seeded
    jcfg, cfg = jax_tiny_config(), tiny_config()
    grids = [grid_for_frames(2, 28, 56, cfg.vision), grid_for_frames(2, 56, 28, cfg.vision)]
    clips = [[frames(2, seed=10 * r + i, h=h, w=w) for i, (h, w) in enumerate([(28, 56), (56, 28)])]
             for r in range(2)]
    patches = np.stack([np.concatenate([device_patchify(T(c)).numpy() for c in row])
                        for row in clips])                                # [2, Np, pd]
    text = chat.render_chat([{"role": "user", "content": [
        {"type": "video", "video": None}, {"type": "text", "text": "and"},
        {"type": "video", "video": None}, {"type": "text", "text": "describe"}]}],
        add_generation_prompt=True)
    row = ByteTokenizer().encode(chat.expand_vision_placeholders(text, video_grid_thw=grids))
    ids = np.asarray([row, row], np.int32)
    pos, _ = pm.get_rope_index(cfg, ids, video_grid_thw=np.asarray(grids * 2))
    s, smax = ids.shape[1], 128
    jvis = jm.prepare_vision_inputs(jcfg, patches[0], grids)
    assert jvis.group is None
    jvis = jm.VisionInputs(jnp.asarray(patches), jvis.cos, jvis.sin, jvis.seg_ids, None)
    jlogits, _ = jm.forward(params, jcfg, jnp.asarray(ids), jnp.asarray(pos), vision=jvis,
                            cache=jm.KVCache.zeros(jcfg.text, 2, smax),
                            attention_mask=jnp.arange(smax)[None, :] < s)
    pvis = pm.VisionInputs(T(patches), T(np.array(jvis.cos)), T(np.array(jvis.sin)),
                           T(np.array(jvis.seg_ids)), None)
    plogits, _ = pm.forward(model, cfg, T(ids), T(pos), pm.KVCache.zeros(cfg.text, 2, smax),
                            vision=pvis)
    ref = np.asarray(jlogits)
    assert np.abs(plogits.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    assert not np.allclose(ref[0], ref[1])          # the rows' clips differ

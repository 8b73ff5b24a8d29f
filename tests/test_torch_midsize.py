"""``livecc_tpu_torch/tools/midsize.py`` on the CPU: its four cases against
the JAX package's ``tests/test_midsize_parity.py`` steps on the tiny config
(fp32, hf_tiny golden weights, within 1e-5), and its recipe state against
the port's 7B-width model at the golden's depth (names and shapes, on the
``meta`` device: no weight is made). The cases at the 7B's width run on the
card: ``tests/test_torch_midsize_gpu.py`` and ``chip_smoke.py``'s
``midsize`` phase.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax.numpy as jnp

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.engine.generation import prefill as jax_prefill
from livecc_tpu.models import qwen2_vl as jm
from livecc_tpu.models.qwen2_vl.text import KVCache as JaxKVCache

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.models.qwen2_vl.bridge import params_from_jax
from livecc_tpu_torch.models.qwen2_vl.convert import _canonicalize, hf_name_map
from livecc_tpu_torch.models.qwen2_vl.model import Qwen2VL
from livecc_tpu_torch.tools import midsize
from livecc_tpu_torch.utils.param_recipe import MIDSIZE_TEXT, MIDSIZE_VISION
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "hf_tiny.npz")


def tiny_inputs(cfg):
    """The golden's inputs at the tiny config's ids (make_midsize_inputs' layout)."""
    rng = np.random.RandomState(0)
    pd = cfg.vision.patch_dim
    vs, ve, vid = cfg.vision_start_token_id, cfg.vision_end_token_id, cfg.video_token_id
    return {
        "text_ids": rng.randint(8, 1000, (1, 24)),
        "mm_grid": np.array([[2, 8, 8]]),
        "mm_patches": rng.randn(128, pd).astype(np.float32),
        "mm_ids": np.concatenate([rng.randint(8, 1000, 3), [vs], [vid] * 32, [ve],
                                  rng.randint(8, 1000, 4)])[None],
        "cont_ids": rng.randint(8, 1000, (1, 8)),
        "v_grid": np.array([[2, 4, 4], [1, 2, 6]]),
        "v_patches": rng.randn(44, pd).astype(np.float32),
    }


def jax_cases(params, cfg, g):
    """tests/test_midsize_parity.py's four computations, on JAX."""
    out = {}
    pos, _ = jm.get_rope_index(cfg, g["text_ids"])
    out["text"] = np.asarray(jm.forward(params, cfg, jnp.asarray(g["text_ids"]),
                                        jnp.asarray(pos))[0][0])
    ids, grid = g["mm_ids"], g["mm_grid"]
    pos1, delta = jm.get_rope_index(cfg, ids, video_grid_thw=grid)
    out["mm_pos"], out["mm_delta"] = pos1, delta
    vis = jm.prepare_vision_inputs(cfg, g["mm_patches"], [tuple(x) for x in grid])
    out["mm"] = np.asarray(jm.forward(params, cfg, jnp.asarray(ids), jnp.asarray(pos1),
                                      vision=vis)[0][0])
    n1, n2 = ids.shape[1], g["cont_ids"].shape[1]
    cache = JaxKVCache.zeros(cfg.text, 1, 128)
    _, cache, _ = jax_prefill(params, cfg, jnp.asarray(ids), jnp.asarray(pos1), jnp.int32(n1),
                              cache, vision=vis)
    pos2 = np.broadcast_to((np.arange(n1, n1 + n2)[None, None, :] + delta[None]
                            ).astype(np.int32), (3, 1, n2))
    kv_limit = cache.offset + n2
    key_valid = np.arange(cache.max_len)[None, :] < np.asarray(kv_limit)[:, None]
    out["cont"] = np.asarray(jm.forward(params, cfg, jnp.asarray(g["cont_ids"]),
                                        jnp.asarray(np.ascontiguousarray(pos2)), cache=cache,
                                        attention_mask=jnp.asarray(key_valid),
                                        kv_limit=kv_limit)[0][0])
    vis = jm.prepare_vision_inputs(cfg, g["v_patches"], [tuple(x) for x in g["v_grid"]])
    out["v_out"] = np.asarray(jm.vision_forward(params["visual"], cfg.vision, vis.patches,
                                                vis.cos, vis.sin, vis.seg_ids))
    return out


def test_cases_match_jax_on_the_tiny_config():
    g = np.load(GOLDEN)
    state = {k[len("state::"):]: g[k] for k in g.files if k.startswith("state::")}
    params = jm.convert_state_dict(state, jax_tiny_config())
    model = params_from_jax(params, tiny_config())
    inputs = tiny_inputs(tiny_config())
    got = midsize.run_cases(model, tiny_config(), inputs)
    want = jax_cases(params, jax_tiny_config(), inputs)
    assert got.keys() == want.keys()
    for k in ("mm_pos", "mm_delta"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("text", "mm", "cont", "v_out"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5, err_msg=k)
    # the check passes JAX's outputs made into a golden, and fails a moved logit
    golden = dict(inputs, mm_pos=want["mm_pos"], mm_delta=want["mm_delta"], v_out=want["v_out"])
    for p in ("text", "mm", "cont"):
        top2 = np.sort(want[p], -1)[:, -2:]
        golden.update({f"{p}_tail": want[p][-4:], f"{p}_argmax": want[p].argmax(-1),
                       f"{p}_margin": top2[:, 1] - top2[:, 0]})
    limits = dataclasses.replace(midsize.FP32, coverage=0.0)
    report = midsize.check(golden, got, limits)
    assert all(r["worst"] <= 1.0 for r in report.values())
    got["cont"] = got["cont"].copy()
    got["cont"][-1, 7] += 0.01
    with pytest.raises(AssertionError, match="cont"):
        midsize.check(golden, got, limits)


def test_recipe_state_covers_the_model_at_width():
    """The golden's manifest names every parameter of the port's 7B-width
    model at depth 4 / 4, in its shape (the patch embed in HF's Conv3d
    shape); the config is the 7B's but for the depths."""
    golden = np.load(os.path.join(os.path.dirname(__file__), "goldens", "hf_midsize.npz"))
    cfg = midsize.config()
    assert (cfg.text.num_hidden_layers, cfg.vision.depth) == (
        MIDSIZE_TEXT["num_hidden_layers"], MIDSIZE_VISION["depth"])
    assert (cfg.text.hidden_size, cfg.text.intermediate_size, cfg.text.vocab_size) == (
        3584, 18944, 152064)
    state = midsize.RecipeState(golden)
    shapes = {_canonicalize(k): v for k, v in state._shapes.items()}
    params = dict(Qwen2VL(cfg, device="meta").named_parameters())
    names = hf_name_map(cfg)
    assert set(names) == set(params) and set(names.values()) <= set(shapes)
    for name, hf in names.items():
        want = tuple(params[name].shape)
        if name == "visual.patch_embed.weight":
            assert np.prod(shapes[hf][1:]) == want[1] and shapes[hf][0] == want[0]
        else:
            assert shapes[hf] == want, name

"""The port's forward at Qwen2-VL-7B's width against HF's golden.

``tests/goldens/hf_midsize.npz`` holds HF transformers' outputs for
Qwen2-VL-7B at full width (hidden 3584, 28q/4kv heads of 128, intermediate
18944, vocab 152064, ViT embed 1280) with 4 LLM layers and 4 ViT blocks, on
weights that ``utils/param_recipe.py`` derives from each parameter's name
(the golden carries the manifest of names and shapes). The JAX package
holds its forward to it in ``tests/test_midsize_parity.py``; this module
does the same for the port, on the card: ``tests/test_torch_midsize_gpu.py``
and ``chip_smoke.py``'s ``midsize`` phase call it.

Cases (``run_cases``): the text logits (uncached forward: K4), the
multimodal logits with the vision tower (K3's group form) and M-RoPE
positions, the streaming continuation (chunk 2 through K1 against chunk
1's cache) and the vision tower alone on two grids (K3's bounds form).
``check`` compares them with the golden: the last 4 rows of logits within
``atol + rtol * |ref|`` and the argmax equal wherever the golden's top-2
margin exceeds ``argmax_eps``; the positions exactly. fp32 uses JAX's
limits (``FP32``); bf16 the limits ``BF16``.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Mapping

import numpy as np
import torch

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.engine.generation import prefill
from livecc_tpu_torch.models.qwen2_vl.convert import convert_state_dict
from livecc_tpu_torch.models.qwen2_vl.model import (
    Qwen2VL, forward, get_rope_index, prepare_vision_inputs)
from livecc_tpu_torch.models.qwen2_vl.text import KVCache
from livecc_tpu_torch.utils.param_recipe import (
    MIDSIZE_TEXT, MIDSIZE_TOKEN_IDS, MIDSIZE_VISION, RECIPE_VERSION, recipe_tensor)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "tests",
                      "goldens", "hf_midsize.npz")


@dataclasses.dataclass(frozen=True)
class Limits:
    atol: float          # logits tail: |out - ref| <= atol + rtol * |ref|
    rtol: float
    argmax_eps: float    # argmax held where the golden's top-2 margin exceeds this
    coverage: float      # share of positions the margin must decide
    vision_atol: float   # the vision tower's output
    vision_rtol: float


# JAX's limits (tests/test_midsize_parity.py): fp32 reduction-order noise
FP32 = Limits(3e-3, 2e-3, 5e-3, 0.99, 1e-3, 1e-3)
# bf16 weights and activations through the kernels: about a fifth of the
# logits' rms (~0.69) and of the vision output's (~0.013); the argmax held
# where the golden's margin exceeds 0.1 (half the positions or more)
BF16 = Limits(0.15, 0.0, 0.1, 0.0, 3e-3, 0.0)


def config() -> ModelConfig:
    """Qwen2-VL-7B's config with the LLM and the ViT cut to the golden's
    depth (4 and 4); every width is the 7B's."""
    full = ModelConfig.qwen2_vl_7b()
    if (MIDSIZE_TEXT["hidden_size"], MIDSIZE_TEXT["vocab_size"], MIDSIZE_VISION["embed_dim"],
            MIDSIZE_TOKEN_IDS["video_token_id"]) != (
            full.text.hidden_size, full.text.vocab_size, full.vision.embed_dim,
            full.video_token_id):
        raise ValueError("param_recipe's MIDSIZE_* no longer match the 7B preset")
    return dataclasses.replace(
        full,
        vision=dataclasses.replace(full.vision, depth=MIDSIZE_VISION["depth"]),
        text=dataclasses.replace(full.text, num_hidden_layers=MIDSIZE_TEXT["num_hidden_layers"]),
    )


class RecipeState(Mapping):
    """The golden's state dict, each tensor made by ``recipe_tensor`` when
    it is asked for (2.1 B fp32 values are never all on the host)."""

    def __init__(self, golden):
        if int(golden["recipe_version"]) != RECIPE_VERSION:
            raise ValueError("the golden was made with another parameter recipe")
        shapes = golden["manifest_shapes"]
        self._shapes = {str(n): tuple(int(d) for d in shapes[i] if d)
                        for i, n in enumerate(golden["manifest_names"])}

    def __getitem__(self, name: str) -> torch.Tensor:
        return torch.from_numpy(recipe_tensor(name, self._shapes[name]))

    def __iter__(self):
        return iter(self._shapes)

    def __len__(self) -> int:
        return len(self._shapes)


def load(device, dtype: torch.dtype = torch.float32, path: str = GOLDEN):
    """(golden, config, model on ``device`` in ``dtype``)."""
    golden = dict(np.load(path))
    cfg = config()
    return golden, cfg, convert_state_dict(RecipeState(golden), cfg, device=device, dtype=dtype)


@torch.no_grad()
def run_cases(model: Qwen2VL, cfg: ModelConfig, golden: dict) -> dict:
    """The four cases' outputs as fp32 numpy: "text", "mm", "cont" logits
    [S, V]; "mm_pos", "mm_delta"; "v_out" [N, H]."""
    dev = next(model.parameters()).device

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    out = {}
    ids = golden["text_ids"]
    pos, _ = get_rope_index(cfg, ids)
    out["text"] = forward(model, cfg, t(ids), t(pos))[0][0].float().cpu().numpy()

    ids, patches, grid = golden["mm_ids"], golden["mm_patches"], golden["mm_grid"]
    grids = [tuple(int(x) for x in g) for g in grid]
    pos, delta = get_rope_index(cfg, ids, video_grid_thw=grid)
    out["mm_pos"], out["mm_delta"] = pos, delta
    vis = prepare_vision_inputs(cfg, patches, grids, dev)
    out["mm"] = forward(model, cfg, t(ids), t(pos), vision=vis)[0][0].float().cpu().numpy()

    # chunk 2 against chunk 1's cache; HF's continuation positions are
    # cache_position + rope_delta on all three axes
    cont = golden["cont_ids"]
    n1, n2 = ids.shape[1], cont.shape[1]
    cache = KVCache.zeros(cfg.text, 1, 128, dtype=model.text.embed.weight.dtype, device=dev)
    _, cache, _ = prefill(model, cfg, t(ids), t(pos), n1, cache, vision=vis)
    pos2 = np.broadcast_to((np.arange(n1, n1 + n2)[None, None, :] + delta[None]
                            ).astype(np.int32), (3, 1, n2))
    logits, _ = forward(model, cfg, t(cont), t(pos2), cache=cache, kv_limit=cache.offset + n2)
    out["cont"] = logits[0].float().cpu().numpy()

    grid, patches = golden["v_grid"], golden["v_patches"]
    vis = prepare_vision_inputs(cfg, patches, [tuple(int(x) for x in g) for g in grid], dev)
    out["v_out"] = model.visual(vis.patches, vis.cos, vis.sin, vis.seg_ids,
                                vis.group).float().cpu().numpy()
    return out


def check(golden: dict, out: dict, limits: Limits) -> dict:
    """Each case against the golden under ``limits``; returns per case the
    worst share of the limit ("worst", <= 1 passes), the max abs error, and
    for logits the share of positions decided and of those whose argmax
    agrees. Raises AssertionError naming the first case that fails."""
    report = {}
    for prefix in ("text", "mm", "cont"):
        logits, ref = out[prefix], golden[f"{prefix}_tail"]
        err = np.abs(logits[-4:] - ref)
        worst = float((err / (limits.atol + limits.rtol * np.abs(ref))).max())
        decided = golden[f"{prefix}_margin"] > limits.argmax_eps
        agree = logits.argmax(-1)[decided] == golden[f"{prefix}_argmax"][decided]
        report[prefix] = {"worst": worst, "max_abs_err": float(err.max()),
                          "decided": float(decided.mean()), "argmax_agree": float(agree.mean())}
        if not worst <= 1.0:
            raise AssertionError(f"midsize {prefix}: logits {worst:.3f}x the limit")
        if not decided.mean() >= limits.coverage:
            raise AssertionError(f"midsize {prefix}: {decided.mean():.3f} of positions decided")
        if not agree.all():
            raise AssertionError(f"midsize {prefix}: argmax differs at {int((~agree).sum())} "
                                 f"decided positions")
    np.testing.assert_array_equal(out["mm_pos"], golden["mm_pos"])
    np.testing.assert_array_equal(out["mm_delta"], golden["mm_delta"])
    ref = golden["v_out"]
    err = np.abs(out["v_out"] - ref)
    worst = float((err / (limits.vision_atol + limits.vision_rtol * np.abs(ref))).max())
    report["v_out"] = {"worst": worst, "max_abs_err": float(err.max())}
    if not worst <= 1.0:
        raise AssertionError(f"midsize v_out: {worst:.3f}x the limit")
    return report

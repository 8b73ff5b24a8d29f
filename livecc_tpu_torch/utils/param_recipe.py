"""Deterministic parameter recipe for width-realistic parity goldens.

A copy of ``livecc_tpu/utils/param_recipe.py`` (numpy only), so that the
port builds the bit-identical weights of ``tests/goldens/hf_midsize.npz``
without the JAX package: ``tests/test_torch_midsize_gpu.py`` and
``chip_smoke.py``'s ``midsize`` phase hold the port's forward to it.

Mid-size parity goldens (VERDICT r3 #2) need a model at REAL Qwen2-VL-7B
width — head_dim 128, GQA 28q/4kv, vocab 152064, hidden 3584 — where the
weights alone are ~2 GB: far too large to commit. Instead both sides derive
every tensor from the same pure-numpy recipe keyed by the HF parameter NAME,
so the torch golden generator (tools/gen_hf_goldens.py, run offline once)
and the torch-free JAX test (tests/test_model_parity.py) materialize
bit-identical weights independently; only the torch OUTPUTS are committed.

The recipe mirrors sane transformer init so depth-4 activations stay
bounded: normals scaled 0.02 for projection/embedding weights, norm weights
at 1 + 0.02*noise (exercising the scale path), small-noise biases.
"""

from __future__ import annotations

import zlib

import numpy as np


def _seed(name: str) -> int:
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


# Per-call sampling of 2.15B variates takes ~15 min on this 1-vCPU host, so
# the recipe is memory-bound instead: one fixed uniform pool, tiled from a
# per-tensor name-hashed offset. The pool length is PRIME, so consecutive
# rows of a [V, H] matrix read offsets r*H mod _POOL_N that never cycle for
# any H < _POOL_N — every vocab row is distinct (argmax margins stay
# meaningful) without any per-row work.
_POOL_N = 1_048_583  # smallest prime > 2^20
_POOL: np.ndarray | None = None
RECIPE_VERSION = 2  # stored in goldens; bump whenever the math here changes


def _pool() -> np.ndarray:
    global _POOL
    if _POOL is None:
        g = np.random.Generator(np.random.SFC64(0xC0FFEE))
        _POOL = (g.random(_POOL_N, dtype=np.float32) * 2.0 - 1.0)
    return _POOL


def recipe_tensor(name: str, shape: tuple[int, ...]) -> np.ndarray:
    """The committed recipe: HF param name + shape -> fp32 tensor.

    Values are uniform in [-0.02, 0.02] for projections/embeddings/biases and
    1 + [-0.02, 0.02] for norm weights — bounded depth-4 activations that
    exercise every path (norm scale, bias add) like a sane init would.
    """
    n = int(np.prod(shape)) if shape else 1
    start = _seed(name) % _POOL_N
    reps = -(-(start + n) // _POOL_N)
    flat = np.tile(_pool(), reps)[start:start + n]
    base = name.rsplit(".", 1)[-1]
    if "norm" in name.lower() and base == "weight":
        return (1.0 + 0.02 * flat).reshape(shape)
    return (0.02 * flat).reshape(shape)


def state_dict_from_manifest(manifest: dict[str, tuple[int, ...]]) -> dict[str, np.ndarray]:
    """Materialize a full HF-layout state dict from {name: shape}."""
    return {name: recipe_tensor(name, tuple(shape)) for name, shape in manifest.items()}


# Depth-reduced Qwen2-VL-7B width (Qwen/Qwen2-VL-7B-Instruct config.json values
# except num_hidden_layers / vision depth): the realistic-width parity config.
MIDSIZE_TEXT = dict(
    vocab_size=152064, hidden_size=3584, intermediate_size=18944,
    num_hidden_layers=4, num_attention_heads=28, num_key_value_heads=4,
    rms_norm_eps=1e-6, rope_theta=1e6, max_position_embeddings=32768,
    tie_word_embeddings=False,
    rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]},
    bos_token_id=151643, eos_token_id=151645, pad_token_id=151643,
)
MIDSIZE_VISION = dict(
    depth=4, embed_dim=1280, num_heads=16, hidden_size=3584, patch_size=14,
    temporal_patch_size=2, spatial_merge_size=2, in_channels=3,
)
MIDSIZE_TOKEN_IDS = dict(
    image_token_id=151655, video_token_id=151656,
    vision_start_token_id=151652, vision_end_token_id=151653,
)

MIDSIZE_PATCH_DIM = 3 * 2 * 14 * 14  # in_channels * temporal_patch * patch^2


def make_midsize_inputs(seed: int = 0) -> dict[str, np.ndarray]:
    """The golden generator's exact input draws, keyed by one seed.

    Shared by tools/gen_hf_midsize_goldens.py (torch side) and
    tools/search_midsize_seed.py (JAX side): near-tie logit positions are a
    statistical property of any random inputs (top-2 gaps of ~152k
    near-Gaussian logits are Exp-distributed with mean ~sigma/4.9, so a few
    percent of positions land under any fixed argmax threshold). The seed
    is therefore SEARCHED on the JAX side until every pinned position
    clears the threshold with margin to spare, then the torch golden is
    generated once from the winning seed (recorded in the golden as
    ``input_seed``).
    """
    rng = np.random.RandomState(seed)
    vs, ve, vid = (MIDSIZE_TOKEN_IDS["vision_start_token_id"],
                   MIDSIZE_TOKEN_IDS["vision_end_token_id"],
                   MIDSIZE_TOKEN_IDS["video_token_id"])
    out: dict[str, np.ndarray] = {}
    out["text_ids"] = rng.randint(8, 10000, size=(1, 24)).astype(np.int64)
    grid = np.array([[2, 8, 8]])
    n_patches = 128
    out["mm_grid"] = grid
    out["mm_patches"] = rng.randn(n_patches, MIDSIZE_PATCH_DIM).astype(np.float32)
    out["mm_ids"] = np.concatenate([
        rng.randint(8, 10000, size=3), [vs], [vid] * (n_patches // 4), [ve],
        rng.randint(8, 10000, size=4),
    ])[None].astype(np.int64)
    out["cont_ids"] = rng.randint(8, 10000, size=(1, 8)).astype(np.int64)
    vgrid = np.array([[2, 4, 4], [1, 2, 6]])
    n = int((vgrid[:, 0] * vgrid[:, 1] * vgrid[:, 2]).sum())
    out["v_grid"] = vgrid
    out["v_patches"] = rng.randn(n, MIDSIZE_PATCH_DIM).astype(np.float32)
    return out

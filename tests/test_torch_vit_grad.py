"""K3's gradient: the backward of ``ops/vit_attention.py:_K3`` against JAX's.

On CUDA both K3 forms run through ``_K3``, whose backward recomputes the
plain version and takes its vjp, as JAX's ``custom_vjp`` takes ``mha``'s
(``livecc_tpu/ops/pallas/vit_attention.py:126-151``). Here, on the CPU,
``_K3`` runs with the plain version in the kernel's place: its gradients
must equal the plain version's autograd exactly and JAX's vjp (its forward
in interpret mode) within 1e-5; and a tiny unfrozen ViT tower's parameter
gradients must equal JAX ``vision_forward``'s within 1e-5 of their scale.
The card's side is ``tests/test_torch_frontdoor_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.models import qwen2_vl as jm
from livecc_tpu.ops.pallas.vit_attention import vit_group_attention as jax_vit_group_attention

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.models.qwen2_vl.bridge import _jax_name_map, params_from_jax
from livecc_tpu_torch.ops.rope import vision_rotary_cos_sin
from livecc_tpu_torch.ops.vit_attention import (
    _K3, vit_group_attention_plain, vit_segment_attention_plain)
from livecc_tpu_torch.tools.session import synth_frames
from livecc_tpu_torch.vision_io.patchify import device_patchify, grid_for_frames
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def grads(fn, arrays):
    """(output, dq, dk, dv) of ``fn(q, k, v)`` with cotangent ``arrays[3]``."""
    q, k, v = (torch.tensor(x, requires_grad=True) for x in arrays[:3])
    out = fn(q, k, v)
    out.backward(torch.from_numpy(arrays[3]))
    return [t.detach().numpy() for t in (out, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("form", ["group", "segment"])
def test_k3_function_gives_the_plain_autograd(form):
    if form == "group":
        arrays, plain = qkv((3, 12, 2, 16), 0), vit_group_attention_plain
    else:
        arrays = qkv((30, 2, 16), 1)

        def plain(q, k, v):
            return vit_segment_attention_plain(q, k, v, [0, 7, 19, 30])
    for a, b in zip(grads(lambda q, k, v: _K3.apply(plain, plain, q, k, v), arrays),
                    grads(plain, arrays)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(3, 12, 2, 16), (1, 40, 4, 80)])
def test_k3_backward_matches_jax_custom_vjp(shape):
    arrays = qkv(shape, 2)
    out, vjp = jax.vjp(lambda q, k, v: jax_vit_group_attention(q, k, v, True),
                       *(jnp.asarray(x) for x in arrays[:3]))
    ref = [out, *vjp(jnp.asarray(arrays[3]))]
    got = grads(lambda q, k, v: _K3.apply(vit_group_attention_plain, vit_group_attention_plain,
                                          q, k, v), arrays)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)


def test_unfrozen_vision_tower_grads_match_jax():
    """The parameter gradients of a tiny ViT tower (uniform groups: K3's
    path) for a fixed linear loss, against ``jax.grad`` of JAX
    ``vision_forward`` through its custom_vjp."""
    jcfg, cfg = jax_tiny_config(), tiny_config()
    params = jm.init_params(jcfg, jax.random.PRNGKey(1))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg)
    frames = synth_frames(4, 56, 28, seed=5)
    grid = grid_for_frames(4, 56, 28, cfg.vision)
    patches = device_patchify(torch.from_numpy(frames))
    cos, sin = vision_rotary_cos_sin([grid], cfg.vision.head_dim)
    seg = np.repeat(np.arange(grid[0]), grid[1] * grid[2]).astype(np.int32)
    group = grid[1] * grid[2]
    n_out = patches.shape[0] // 4
    w = np.random.RandomState(6).standard_normal((n_out, cfg.vision.hidden_size)).astype(np.float32)

    def jax_loss(visual):
        out = jm.vision_forward(visual, jcfg.vision, jnp.asarray(patches.numpy()), cos, sin, seg,
                                group, use_flash=True, score_dtype=None)
        return (out * w).sum()

    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        jgrads = jax.grad(jax_loss)(params["visual"])
    model.visual.requires_grad_(True)
    out = model.visual(patches, torch.from_numpy(cos), torch.from_numpy(sin),
                       torch.from_numpy(seg), group)
    (out * torch.from_numpy(w)).sum().backward()
    tree = {"visual": jax.tree_util.tree_map(np.asarray, jgrads)}
    checked = 0
    for name, (path, layer, transpose) in _jax_name_map(cfg).items():
        if not name.startswith("visual."):
            continue
        ref = tree
        for key in path:
            ref = ref[key]
        ref = ref[layer] if layer is not None else ref
        ref = ref.T if transpose else ref
        got = dict(model.named_parameters())[name].grad.numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0, err_msg=name)
        checked += 1
    assert checked == len(list(model.visual.parameters()))

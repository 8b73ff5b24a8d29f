"""K3's bounds form and the K1 / K3 tile checks, on the CPU.

``vit_segment_attention`` runs ViT attention within segments given by their
bounds (mixed grids in one tower call); its plain version is held to the
JAX tower's segment-mask ``mha`` (fp32, 1e-5), and on evenly spaced bounds
to ``vit_group_attention_plain``. ``segment_bounds`` turns segment ids into
bounds and raises where JAX's equality mask would join two runs. A tower
call on two clips of different grids is held to JAX ``vision_forward``
(group None, fp32, 1e-5).

``kernel_check.close`` must pass what the bf16 tensor-core kernels compute
(``csrc/wgmma_attention.cuh``: an online softmax over 64-key tiles, p
rounded to bf16 at the running max; K1's packed rows, split keys and merge,
K3's 128-row tiles and D = 80 tail, which ``tests/torch_wgmma_tiles.py``
emulates) and fail a dropped key tile (``kernel_check.drop_key_tile`` in
K1's last split, ``vit_drop_key_tile``) at the shapes the card is checked
and timed at.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.models import qwen2_vl as jm
from livecc_tpu.ops.attention import mha as jax_mha
from livecc_tpu.vision_io.patchify import device_patchify as jax_device_patchify

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.models import qwen2_vl as pm
from livecc_tpu_torch.ops.flash_attention import PREFILL_KEYS, PREFILL_ROWS, flash_prefill_plain
from livecc_tpu_torch.ops.rope import vision_rotary_cos_sin
from livecc_tpu_torch.ops.vit_attention import (
    segment_bounds, vit_group_attention, vit_group_attention_plain, vit_segment_attention,
    vit_segment_attention_plain)
from livecc_tpu_torch.tools import kernel_check, kernel_timing
from livecc_tpu_torch.vision_io.patchify import device_patchify, grid_for_frames
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_wgmma_tiles import prefill_tiles, vit_tiles

T = torch.from_numpy


def seg_ids(lengths, pad=0):
    """int32 ids: run i of ``lengths[i]`` rows has id 10 * i + 3, then a run
    of ``pad`` pad rows (-1)."""
    ids = [np.full(n, 10 * i + 3) for i, n in enumerate(lengths)] + [np.full(pad, -1)]
    return np.concatenate(ids).astype(np.int32)


@pytest.mark.parametrize("lengths,pad,h,d", [
    ((5, 17, 9), 4, 2, 16),
    ((64, 3, 70), 1, 4, 16),
    ((12, 30, 7), 6, 2, 80),          # the 7B ViT's head dim
])
def test_segment_plain_matches_jax_mha(lengths, pad, h, d):
    """Runs of three lengths and a pad run against JAX ``mha`` with the
    segment-equality mask (``livecc_tpu/models/qwen2_vl/vision.py:121``)."""
    ids = seg_ids(lengths, pad)
    n = ids.size
    rng = np.random.RandomState(n + d)
    q, k, v = (rng.randn(n, h, d).astype(np.float32) for _ in range(3))
    cu, longest = segment_bounds(T(ids))
    assert longest == max(*lengths, pad) and len(cu) == len(lengths) + 2
    out = vit_segment_attention(T(q), T(k), T(v), torch.tensor(cu, dtype=torch.int32), longest)
    mask = jnp.asarray(ids[:, None] == ids[None, :])[None, None]
    ref = jax_mha(*(jnp.asarray(x)[None] for x in (q, k, v)), mask=mask)[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("ng,g,dtype", [(3, 20, torch.float32), (2, 70, torch.float32),
                                         (4, 9, torch.bfloat16)])
def test_uniform_bounds_equal_the_group_plain(ng, g, dtype):
    gen = torch.Generator().manual_seed(ng * g)
    q, k, v = (torch.randn((ng, g, 2, 16), generator=gen).to(dtype) for _ in range(3))
    ref = vit_group_attention_plain(q, k, v)
    cu, longest = segment_bounds(torch.arange(ng).repeat_interleave(g))
    assert cu == list(range(0, (ng + 1) * g, g)) and longest == g
    out = vit_segment_attention(*(x.reshape(ng * g, 2, 16) for x in (q, k, v)),
                                torch.tensor(cu, dtype=torch.int32), g)
    assert torch.equal(out.view(ng, g, 2, 16), ref)
    assert torch.equal(vit_group_attention(q, k, v), ref)      # the CPU route is the plain version


@pytest.mark.parametrize("ids", [[1, 1, 2, 2, 1], [0, 3, 0], [-1, -1, 5, -1], [7, 8, 7, 8]])
def test_recurring_id_raises(ids):
    """JAX's equality mask would join runs of one id; bounds cannot."""
    with pytest.raises(ValueError, match="recurs"):
        segment_bounds(torch.tensor(ids, dtype=torch.int32))


@pytest.mark.parametrize("ids,cu,longest", [
    ([4], [0, 1], 1),
    ([2, 2, 2, 9, 9, -1, -1], [0, 3, 5, 7], 3),
    ([0, 1, 1, 1, 1, 2], [0, 1, 5, 6], 4),
    ([-1, -1, -1], [0, 3], 3),
])
def test_segment_bounds(ids, cu, longest):
    assert segment_bounds(np.asarray(ids, np.int32)) == (cu, longest)


def test_segment_attention_rejects_bounds_that_do_not_split():
    x = torch.zeros(6, 2, 16)
    for cu, longest in (([0, 3, 5], 3), ([0, 3, 3, 6], 3), ([1, 6], 5), ([0, 2, 6], 3)):
        with pytest.raises(ValueError):
            vit_segment_attention(x, x, x, torch.tensor(cu, dtype=torch.int32), longest)


@pytest.mark.parametrize("shapes", [[(4, 56, 28), (2, 28, 84)], [(2, 28, 28), (6, 56, 56)]])
def test_vision_tower_mixed_grids_matches_jax(shapes):
    """Two clips of different grids in one tower call (no uniform group):
    the port's bounds form against JAX ``vision_forward(group_size=None)``,
    which runs ``mha`` with the segment mask."""
    import jax

    params = jm.init_params(jax_tiny_config(), jax.random.PRNGKey(0))
    model = pm.params_from_jax(jax.tree_util.tree_map(np.asarray, params), tiny_config())
    cfg = tiny_config().vision
    rng = np.random.RandomState(len(shapes[1]) + shapes[1][0])
    clips = [rng.randint(0, 256, size=(t, hh, ww, 3), dtype=np.uint8) for t, hh, ww in shapes]
    grids = [grid_for_frames(*f.shape[:3], cfg) for f in clips]
    assert grids[0][1:] != grids[1][1:]
    seg = np.concatenate([np.repeat(np.arange(t) + 100 * i, h * w)
                          for i, (t, h, w) in enumerate(grids)]).astype(np.int32)
    cos, sin = vision_rotary_cos_sin(grids, cfg.head_dim)
    out = model.visual(torch.cat([device_patchify(T(f)) for f in clips]), T(cos), T(sin), T(seg))
    ref = jm.vision_forward(params["visual"], jax_tiny_config().vision,
                            jnp.concatenate([jax_device_patchify(jnp.asarray(f)) for f in clips]),
                            cos, sin, seg, None)
    n = sum(t * h * w for t, h, w in grids)
    assert out.shape == (n // 4, cfg.hidden_size)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the tile checks: close passes the kernels' arithmetic, fails a dropped tile
# ---------------------------------------------------------------------------

def prefill_case(sq, off, lim, seed):
    """K1 at one of the card's timed shapes (B = 1, Hq 28, Hk 4, D 128, a
    one-layer cache of 2048 > kv_limit), bf16, with the kernel's emulation,
    the plain version and the planted fault: one key tile of the last live
    split of the last query tile's block dropped."""
    gen = torch.Generator().manual_seed(seed)
    hq, hk, d = 28, 4, 128
    q = torch.randn((1, hq, sq, d), generator=gen).bfloat16()
    k, v = (torch.randn((1, hk, 2048, d), generator=gen).bfloat16() for _ in range(2))
    off_t, lim_t = torch.tensor([off], dtype=torch.int32), torch.tensor([lim], dtype=torch.int32)
    ref = flash_prefill_plain(q, k, v, off_t, lim_t)
    qt = (sq - 1) // 64
    kt, split, live = kernel_check.split_key_tile(hq, hk, sq, off, lim, 2048, qt)
    assert live == 1 or split >= 1
    fault = kernel_check.drop_key_tile(ref, q, k, v, off_t, lim_t, qt, kt, head=5)
    return prefill_tiles(q, k, v, [off], [lim]), ref, fault


def vit_case(ng, g, seed):
    """K3 at one of the card's timed shapes (H 16, D 80), bf16."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((ng * g, 16, 80), generator=gen).bfloat16() for _ in range(3))
    cu = list(range(0, (ng + 1) * g, g))
    ref = vit_segment_attention_plain(q, k, v, cu)
    fault = kernel_check.vit_drop_key_tile(ref, q, k, v, cu, ng - 1, (g - 1) // 64, g // 128,
                                           head=3)
    return vit_tiles(q, k, v, cu), ref, fault


@pytest.mark.parametrize("kind,shape", [("K1", s) for s in kernel_timing.PREFILL_SHAPES]
                         + [("K3", s) for s in kernel_timing.VIT_SHAPES])
def test_check_fails_a_dropped_key_tile_at_the_card_shapes(kind, shape):
    """At each timed shape: the kernels' tile-wise arithmetic passes
    ``close`` against the plain version in bf16; one dropped 64-key tile of
    one 64-query tile fails it at least 5x over."""
    out, ref, fault = prefill_case(*shape, 60) if kind == "K1" else vit_case(*shape, 61)
    assert kernel_check.close(out, ref, torch.bfloat16) <= 1.0
    assert kernel_check.close(fault, ref, torch.bfloat16) >= 5.0


def test_drop_key_tile_edges():
    q, k = torch.zeros(1, 2, 100, 16), torch.zeros(1, 1, 256, 16)
    off, lim = torch.tensor([0], dtype=torch.int32), torch.tensor([100], dtype=torch.int32)
    ref = flash_prefill_plain(q, k, k, off, lim)
    with pytest.raises(ValueError, match="attends no key"):        # causal: tile 1 is in the future
        kernel_check.drop_key_tile(ref, q, k, k, off, lim, 0, 1)
    with pytest.raises(ValueError, match="no query tile"):
        kernel_check.drop_key_tile(ref, q, k, k, off, lim, 2, 0)
    fault = kernel_check.drop_key_tile(ref, q, k, k, off, lim, 1, 0, head=1)
    assert torch.equal(fault[:, 0], ref[:, 0]) and torch.equal(fault[:, 1, :64], ref[:, 1, :64])


def test_tiles_are_the_kernels_constants():
    """``kernel_check.TILE`` is bf16 K1's and K3's key tile, and the grid's
    rows and keys (``ops/flash_attention.py``) are the header's."""
    import livecc_tpu_torch

    header = Path(livecc_tpu_torch.__file__).parent / "csrc" / "wgmma_attention.cuh"
    text = header.read_text()
    for name, want in (("kWgKeys", kernel_check.TILE), ("kWgKeys", PREFILL_KEYS),
                       ("kWgRows", PREFILL_ROWS)):
        assert re.findall(rf"constexpr int {name} = (\d+);", text) == [str(want)]

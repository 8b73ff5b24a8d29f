"""bf16 K1's and K3's tiling (``csrc/wgmma_attention.cuh``), on the CPU.

``tests/torch_wgmma_tiles.py`` goes through the kernels' steps in PyTorch:
K1's G query heads of a KV head packed into a tile's rows, its keys split
across blocks by ``prefill_plan`` / ``prefill_span`` and the partials
merged; K3's 128-row tiles from each segment's first row, D = 80 as a
64-column chunk and a 16-column tail (or rounded up to 128). In fp32 the
emulations are held to the JAX kernels, ``flash_prefill`` and
``vit_group_attention`` in interpret mode, and to the JAX tower's
segment-mask ``mha``, at 1e-5; the grid's rules are checked on their own:
every key tile of a query tile in exactly one live split, and the block
counts at the card's timed shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from livecc_tpu.ops.attention import mha as jax_mha
from livecc_tpu.ops.pallas.attention import flash_prefill as jax_flash_prefill
from livecc_tpu.ops.pallas.vit_attention import vit_group_attention as jax_vit_group_attention

from livecc_tpu_torch.ops.flash_attention import (PREFILL_MAX_SPLIT, flash_prefill_plain,
                                                  prefill_plan, prefill_span)
from livecc_tpu_torch.ops.vit_attention import vit_segment_attention_plain
from livecc_tpu_torch.tools import kernel_check, kernel_timing
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_wgmma_tiles import prefill_tiles, vit_tiles

T = torch.from_numpy


# (b, hq, hk, d, sq, smax, offsets, limits): what each case shows
PREFILL_CASES = {
    # the 7B's G = 7 at a verify window's 9 queries: 63 rows, one tile, its
    # 209 keys in 4 live splits of the 16 the grid has, merged
    "G=7 window": (1, 14, 2, 64, 9, 300, [200], [209]),
    # three rows at their own depths, one short of its chunk, one past a
    # limit inside the chunk, one deep: two tiles of 32 queries at G = 4
    "ragged batch": (3, 8, 2, 32, 40, 320, [0, 37, 150], [40, 60, 190]),
    # row 0 has no valid key (its tile no live split: zeros); row 1 two
    "no valid key": (2, 4, 1, 16, 20, 128, [0, 50], [0, 100]),
    # 16 splits: row 0 uses 9, row 1 one; the rest lie past the rows' limits
    "splits past a limit": (2, 4, 2, 16, 30, 600, [500, 10], [530, 20]),
}


def prefill_inputs(b, hq, hk, d, sq, smax, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hq, sq, d).astype(np.float32)
    k, v = (rng.randn(b, hk, smax, d).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("name", list(PREFILL_CASES))
def test_prefill_tiles_match_jax(name):
    """K1's packed rows, split keys and merge, in fp32, against JAX
    ``flash_prefill`` (Pallas, interpret mode) and the plain version, 1e-5;
    each case's tiles show what it names."""
    b, hq, hk, d, sq, smax, offsets, limits = PREFILL_CASES[name]
    q, k, v = prefill_inputs(b, hq, hk, d, sq, smax, sum(limits))
    stats = []
    out = prefill_tiles(T(q), T(k), T(v), offsets, limits, stats)
    ref = jax_flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(offsets, jnp.int32), jnp.asarray(limits, jnp.int32),
                            bq=min(32, sq), bk=64, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    plain = flash_prefill_plain(T(q), T(k), T(v), torch.tensor(offsets, dtype=torch.int32),
                                torch.tensor(limits, dtype=torch.int32))
    torch.testing.assert_close(out, plain, atol=1e-5, rtol=0)
    nsplit = prefill_plan(b, hq, hk, sq)[2]
    live = [s[3] for s in stats]
    assert max(live) >= 2                          # a merge in every case
    if name == "no valid key":
        assert 0 in live and not out[0].any()
    if name == "splits past a limit":
        assert nsplit == PREFILL_MAX_SPLIT and max(live) < nsplit and 1 in live
    if name == "G=7 window":
        assert prefill_plan(b, hq, hk, sq)[:2] == (18, 1) and live == [4, 4]


@pytest.mark.parametrize("name", list(PREFILL_CASES))
def test_prefill_ignores_the_cache_past_kv_limit(name):
    """With NaN and Inf in every K and V row at or past a row's limit, the
    emulation (whose V rows there are cleared, as the kernel clears them
    before P V) and the plain version give what JAX ``flash_prefill``
    (interpret mode) gives on the finite cache, 1e-5."""
    b, hq, hk, d, sq, smax, offsets, limits = PREFILL_CASES[name]
    q, k, v = prefill_inputs(b, hq, hk, d, sq, smax, sum(limits))
    pos = np.arange(smax)[None, None, :, None]
    past = pos >= np.asarray(limits)[:, None, None, None]
    bad_k = np.where(past, np.nan, k).astype(np.float32)
    bad_v = np.where(past, np.where(pos % 2, np.inf, np.nan), v).astype(np.float32)
    ref = np.asarray(jax_flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(offsets, jnp.int32),
                                       jnp.asarray(limits, jnp.int32),
                                       bq=min(32, sq), bk=64, interpret=True))
    out = prefill_tiles(T(q), T(bad_k), T(bad_v), offsets, limits)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    plain = flash_prefill_plain(T(q), T(bad_k), T(bad_v), torch.tensor(offsets, dtype=torch.int32),
                                torch.tensor(limits, dtype=torch.int32))
    np.testing.assert_allclose(plain.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_prefill_splits_cover_each_key_tile_once(seed):
    """For any key range and split count, the live splits are non-empty and
    walk every key tile of [0, n) once, in order; none past them."""
    rng = np.random.RandomState(seed)
    for kv_end, nsplit in zip(rng.randint(-5, 3000, 200), rng.randint(1, 17, 200)):
        n, per, live = prefill_span(int(kv_end), int(nsplit))
        assert n == max(0, -(-int(kv_end) // 64)) and live <= nsplit
        walked = [t for s in range(live) for t in range(s * per, min(n, (s + 1) * per))]
        assert walked == list(range(n))
        assert all(s * per < n for s in range(live)) and live * per >= n


@pytest.mark.parametrize("hq,hk,sq,off,lim,want", [
    (28, 4, 1024, 0, 690, (18, 57, 1, 228, 228)),
    (28, 4, 256, 1500, 1756, (18, 15, 2, 120, 120)),
    (28, 4, 9, 1500, 1509, (18, 1, 16, 64, 48)),
    (14, 2, 256, 1500, 1756, (18, 15, 4, 120, 120)),     # a TP rank's heads, M = 2
    (14, 2, 9, 1500, 1509, (18, 1, 16, 32, 24)),
    (7, 1, 256, 1500, 1756, (18, 15, 8, 120, 107)),      # M = 4
    (7, 1, 9, 1500, 1509, (18, 1, 16, 16, 12)),
])
def test_prefill_grid_at_the_card_shapes(hq, hk, sq, off, lim, want):
    """(queries a tile, tiles, splits, blocks launched, blocks that walk
    keys) at ``kernel_timing.PREFILL_SHAPES`` and the TP ranks' shapes, B =
    1 on the 7B's cache of 8192; the last split of a tile with more than
    one holds a key tile that the planted fault drops."""
    assert (sq, off, lim) in kernel_timing.PREFILL_SHAPES or hq != 28
    assert prefill_plan(1, hq, hk, sq) + kernel_check.prefill_blocks(
        1, hq, hk, sq, [off], [lim], 8192) == want
    k_tile, split, live = kernel_check.split_key_tile(hq, hk, sq, off, lim, 8192, (sq - 1) // 64)
    assert split == live - 1 and (live == 1 or split >= 1)
    assert 64 * k_tile < min(lim, off + sq)


SEGMENTS = (130, 7, 200, 64, 1)      # partial query and key tiles, a one-row segment


@pytest.mark.parametrize("tail", [True, False])
def test_vit_tiles_match_jax_segment_mha(tail):
    """K3's 128-row tiles over mixed segments, D = 80 with its tail or
    rounded to 128, in fp32: against JAX ``mha`` with the segment-equality
    mask and the plain bounds form, 1e-5."""
    n, h, d = sum(SEGMENTS), 2, 80
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(n, h, d).astype(np.float32) for _ in range(3))
    cu = np.concatenate([[0], np.cumsum(SEGMENTS)])
    ids = np.repeat(np.arange(len(SEGMENTS)), SEGMENTS)
    out = vit_tiles(T(q), T(k), T(v), cu, tail)
    mask = jnp.asarray(ids[:, None] == ids[None, :])[None, None]
    ref = jax_mha(*(jnp.asarray(x)[None] for x in (q, k, v)), mask=mask)[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    torch.testing.assert_close(out, vit_segment_attention_plain(T(q), T(k), T(v), cu.tolist()),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("tail", [True, False])
def test_vit_tiles_match_jax_groups(tail):
    """Uniform groups (NG = 3 of g = 150: two query tiles, the second
    partial, three key tiles) against JAX ``vit_group_attention`` in
    interpret mode, 1e-5."""
    ng, g, h, d = 3, 150, 2, 80
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(ng, g, h, d).astype(np.float32) for _ in range(3))
    out = vit_tiles(*(T(x).reshape(ng * g, h, d) for x in (q, k, v)),
                    list(range(0, (ng + 1) * g, g)), tail)
    ref = jax_vit_group_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    np.testing.assert_allclose(out.reshape(ng, g, h, d).numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)

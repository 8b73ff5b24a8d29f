"""bf16 K1-int8's tensor-core kernel (``csrc/quant_mma_attention.cuh``), its
tile-wise arithmetic emulated in PyTorch on the CPU.

The kernel runs only on the card; what it computes is written out here tile
by tile and held in bf16 by ``kernel_check.close``:

  * int8 K and V widened exactly to bf16; S = Q K^T of bf16 operands summed
    in fp32, then ``(s * d**-0.5) * k_scale[key]`` in that order;
  * causal and limit masks, an online softmax over 64-key tiles in log2
    units (exp2 of ``s * log2(e)`` against the running max), ``l`` summing p
    before the value scale;
  * ``p * v_scale[key]`` in fp32, split into ``P_TERMS`` bf16 parts (hi =
    bf16(pv), mid = bf16(pv - hi), lo = bf16(pv - hi - mid)), each part a
    bf16 product against V into one fp32 accumulator; normalised at the end.

The references: JAX ``flash_prefill`` with scales in interpret mode (the
Pallas kernel's ``quantized`` branch on the CPU, fp32 p against fp32 V) and
the port's plain version, both on the same bf16 queries and int8 cache.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from livecc_tpu.models.qwen2_vl.text import quantize_kv as jax_quantize_kv
from livecc_tpu.ops.pallas.attention import flash_prefill as jax_flash_prefill

import livecc_tpu_torch
from livecc_tpu_torch.ops.flash_attention import flash_prefill_plain
from livecc_tpu_torch.tools import kernel_check
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TILE = kernel_check.TILE
BF16 = torch.bfloat16
NEG = float(torch.finfo(torch.float32).min)
LOG2E = 1.4426950408889634
HEADER = Path(livecc_tpu_torch.__file__).parent / "csrc" / "quant_mma_attention.cuh"
P_TERMS = 3         # bf16 parts of p * v_scale: kQuantPTerms of HEADER
# the pool's shapes cut down: the 7B's group of 7 q heads on one KV head at
# D = 128, three rows at different depths, row 2 stopping mid-chunk
HQ, HK, D = 7, 1, 128
SHALLOW = dict(sq=128, smax=1024, offsets=(0, 300, 700), limits=(128, 428, 790))
# a steady tick: every row ~1300 keys deep, a 256-query chunk
STEADY = dict(sq=256, smax=2048, offsets=(1300, 1290, 1311), limits=(1556, 1546, 1567))


def split_bf16(x, terms):
    """x as ``terms`` bf16 parts (in fp32), each the rounding of what the
    earlier parts left, as the kernel splits p * v_scale."""
    parts = []
    for _ in range(terms):
        parts.append(x.to(BF16).float())
        x = x - parts[-1]
    return parts


def case(sq, smax, offsets, limits, seed=0):
    """bf16 q [3, 7, sq, 128]; an int8 cache (codes and lane-major bf16
    scales, JAX's quantizer) as numpy-fed JAX arrays and as torch tensors;
    offsets and limits."""
    rng = np.random.RandomState(seed)
    b = len(offsets)
    torch_side, jax_side = [], []
    for _ in range(2):
        codes, scale = jax_quantize_kv(jnp.asarray(rng.randn(b, HK, smax, D).astype(np.float32)))
        scale = jnp.swapaxes(scale, -1, -2)
        jax_side += [codes, scale]
        torch_side += [torch.from_numpy(np.array(codes)),
                       torch.from_numpy(np.array(scale.astype(jnp.float32))).to(BF16)]
    q = torch.from_numpy(rng.randn(b, HQ, sq, D).astype(np.float32)).to(BF16)
    off, lim = (torch.tensor(x, dtype=torch.int32) for x in (offsets, limits))
    return q, torch_side, jax_side, off, lim


def quant_tiles(q, k, v, k_scale, v_scale, off, lim, terms=P_TERMS):
    """The kernel's arithmetic, fp32 before the output's rounding. p *
    v_scale meets V as ``terms`` bf16 parts, or as exact fp32 with
    ``terms=None``."""
    b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    kk, vv, ks, vs = (x.float().repeat_interleave(g, 1) for x in (k, v, k_scale, v_scale))
    qpos = off[:, None] + torch.arange(sq)[None]                          # [B, Sq]
    m = torch.full((b, hq, sq, 1), NEG)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hq, sq, d))
    for k0 in range(0, int(torch.minimum(lim, off + sq).max()), TILE):
        kpos = torch.arange(k0, k0 + TILE)
        ok = (kpos[None, None] <= qpos[..., None]) & (kpos[None, None] < lim[:, None, None])
        ok = ok[:, None]                                                   # [B, 1, Sq, 64]
        s = (q.float() @ kk[:, :, k0:k0 + TILE].transpose(-1, -2)) * d ** -0.5
        s = torch.where(ok, s * ks[..., k0:k0 + TILE] * LOG2E, torch.full((), NEG))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s - m_new), torch.zeros(()))
        l = l * alpha + p.sum(-1, keepdim=True)
        pv, vt = p * vs[..., k0:k0 + TILE], vv[:, :, k0:k0 + TILE]
        acc = acc * alpha + (pv @ vt if terms is None else
                             sum(part @ vt for part in split_bf16(pv, terms)))
        m = m_new
    return acc / torch.where(l > 0, l, torch.ones_like(l))


def jax_int8_prefill(q, jax_side, off, lim):
    """JAX ``flash_prefill`` with scales in interpret mode on the same bf16
    q and int8 cache, as bf16 torch."""
    kj, ksj, vj, vsj = jax_side
    out = jax_flash_prefill(jnp.asarray(q.float().numpy()).astype(jnp.bfloat16), kj, vj,
                            jnp.asarray(off.numpy()), jnp.asarray(lim.numpy()),
                            k_scale=ksj, v_scale=vsj, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32))).to(BF16)


@pytest.fixture(scope="module")
def shallow():
    """``SHALLOW``'s inputs, the kernel's arithmetic and JAX's output."""
    q, (k, ks, v, vs), jax_side, off, lim = case(**SHALLOW)
    args = (q, k, v, ks, vs, off, lim)
    return args, quant_tiles(*args), jax_int8_prefill(q, jax_side, off, lim)


@pytest.mark.parametrize("ref", ["jax", "plain"])
def test_tiles_match_the_references(shallow, ref):
    """The kernel's arithmetic against JAX's int8 branch in interpret mode
    and against the plain version, within ``kernel_check.close`` in bf16."""
    (q, k, v, ks, vs, off, lim), out, jax_out = shallow
    r = jax_out if ref == "jax" else flash_prefill_plain(q, k, v, off, lim, ks, vs)
    assert kernel_check.close(out.to(BF16), r, BF16) <= 1.0


def test_tiles_match_the_plain_version_at_a_steady_tick():
    """Every row ~1300 keys deep, 256 queries: the kernel's arithmetic
    within ``kernel_check.close`` of the plain version in bf16."""
    q, (k, ks, v, vs), _, off, lim = case(**STEADY, seed=1)
    out = quant_tiles(q, k, v, ks, vs, off, lim)
    assert kernel_check.close(out.to(BF16), flash_prefill_plain(q, k, v, off, lim, ks, vs),
                              BF16) <= 1.0


def test_the_split_keeps_p_times_v_scale(shallow):
    """Three bf16 parts hold p * v_scale to within 1e-5 of fp32 P·V (each
    row's error norm over the row's norm, before the output is rounded),
    where one part (p * v_scale rounded once) strays past 1e-3. Against
    JAX, in ``close``'s bf16 limit: one part uses more of it than two, two
    more than three; that is why the kernel keeps three."""
    (q, k, v, ks, vs, off, lim), out, jax_out = shallow
    exact = quant_tiles(q, k, v, ks, vs, off, lim, None)

    def row_err(o):
        return ((o - exact).norm(dim=-1) / exact.norm(dim=-1)).max().item()

    one, two = (quant_tiles(q, k, v, ks, vs, off, lim, n) for n in (1, 2))
    assert row_err(out) <= 1e-5
    assert row_err(one) >= 1e-3
    shares = [kernel_check.close(o.to(BF16), jax_out, BF16) for o in (one, two, out)]
    print("share of the bf16 limit against JAX, 1 / 2 / 3 parts: "
          + " / ".join(f"{x:.3f}" for x in shares))
    assert shares[0] > shares[1] > shares[2]


@pytest.mark.parametrize("shape,seed", [(SHALLOW, 0), (STEADY, 1)], ids=["shallow", "steady"])
def test_the_split_keeps_the_roundings(shape, seed):
    """The check that tells the parts apart on the card: against the plain
    version computed in fp32 and rounded to bf16, the kernel's arithmetic
    rounds under ``kernel_check.FLIP_LIMIT`` of its outputs the other way
    (as often as the exact fp32 product does), while one bf16 part, and the
    planted ``kernel_check.one_part_pv``, flip more than 20x as many."""
    q, (k, ks, v, vs), _, off, lim = case(**shape, seed=seed)
    args = (q, k, v, ks, vs, off, lim)
    ref32 = flash_prefill_plain(q.float(), k, v, off, lim, ks, vs)
    kept, exact, two, one = (quant_tiles(*args, n).to(BF16) for n in (P_TERMS, None, 2, 1))
    fault = kernel_check.one_part_pv(q, k, v, off, lim, ks, vs).to(BF16)
    flips = [kernel_check.rounding_flips(o, ref32) for o in (kept, exact, two, one, fault)]
    print("outputs off the fp32 rounding, 3 parts / exact / 2 / 1 / one_part_pv: "
          + " / ".join(f"{x:.2e}" for x in flips))
    assert flips[0] <= kernel_check.FLIP_LIMIT and flips[0] <= 2 * flips[1]
    assert min(flips[3:]) > 20 * kernel_check.FLIP_LIMIT


@pytest.mark.parametrize("row,q_tile,k_tile,head", [(2, 1, 6, 3), (1, 0, 2, 6)])
def test_a_dropped_key_tile_fails(shallow, row, q_tile, k_tile, head):
    """``kernel_check.drop_key_tile`` with the scales (the plain output
    without one 64-key tile of one 64-query tile of one head) fails the
    check against the kernel's arithmetic at least 5x over."""
    (q, k, v, ks, vs, off, lim), out, _ = shallow
    ref = flash_prefill_plain(q, k, v, off, lim, ks, vs)
    fault = kernel_check.drop_key_tile(ref, q, k, v, off, lim, q_tile, k_tile, head, row,
                                       k_scale=ks, v_scale=vs)
    assert not torch.equal(fault, ref)
    assert kernel_check.close(out.to(BF16), fault, BF16) >= 5.0


def test_int8_tiles_are_the_kernels_constants():
    """``kernel_check.TILE`` is the kernel's query and key tile and
    ``P_TERMS`` its number of bf16 parts of p * v_scale."""
    text = HEADER.read_text()
    for name, value in (("kQuantTileQ", TILE), ("kQuantTileK", TILE), ("kQuantPTerms", P_TERMS)):
        assert re.findall(rf"constexpr int {name} = (\d+);", text) == [str(value)]

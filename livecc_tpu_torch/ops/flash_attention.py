"""Cached attention for the streaming path: K1 ``flash_prefill``, K2 ``flash_decode``.

Port of ``livecc_tpu/ops/pallas/attention.py``, both branches. Same layouts
as the JAX kernels:

  * q ``[B, Hq, Sq, D]`` — any strides with a unit-stride head dim, so the
    text tower passes its ``[B, S, Hq, D]`` activations through a transposed
    view without a copy;
  * cache ``[B, Hk, Smax, D]``, or the stacked ``[L, B, Hk, Smax, D]`` cache
    plus a ``layer_index`` (the layer's view is passed, nothing is copied);
  * ``offset`` / ``kv_limit`` — int or int32 ``[B]``: every row sits at its
    own depth. On the GPU they are read inside the kernel (no host sync);
  * ``k_scale`` / ``v_scale`` — an int8 cache's bf16 scales, lane-major
    ``[B, Hk, 1, Smax]`` (or ``[L, B, Hk, 1, Smax]`` with the layer index).

Each wrapper runs its CUDA kernel for CUDA tensors (``csrc/flash_prefill.cu``,
``csrc/flash_decode.cu``; with scales ``csrc/flash_prefill_int8.cu``,
``csrc/flash_decode_int8.cu``) and its plain PyTorch version for CPU
tensors; any other device raises. bf16 K1 and bf16 K1-int8 run on the
tensor cores (``csrc/wgmma_attention.cuh``, ``csrc/quant_mma_attention.cuh``:
head dim a multiple of 16, 16-byte aligned rows, checked here), fp32 K1 and
fp32 K1-int8 on the FMA pipes. The plain
versions below reproduce the kernels' semantics, including a zero output
for a row with no valid key.
bf16 K1 packs the G query heads of a KV head into a tile's rows and splits
a tile's keys across blocks (``prefill_plan``, ``prefill_span``); where a
tile has more than one live split, the partials go to a workspace
allocated here and a merge kernel combines them, from the same C call. Its
K / V tensor maps are encoded once per cache (``_cache_maps``).
The decode kernel splits each row's keys into blocks of ``DECODE_SPLIT``,
and the last block of a row to finish merges the row's partials, in split
order, in the same launch (``_arrival_counters``); ``flash_decode_split_plain``
and ``flash_decode_merge_plain`` mirror those two steps for the tests.
The output is ``[B, Hq, Sq, D]``; on the GPU it is a transposed view of a
``[B, Sq, Hq, D]`` buffer, so the caller's swap back is free.

The int8 branch keeps the TPU kernel's order (``attention.py:78-99``,
``:220-238``): K widened to the query dtype, ``s = (q·k) * d**-0.5 *
k_scale[key]`` in fp32, the running sum ``l`` taken BEFORE the value scale,
then ``p * v_scale[key]`` stays fp32 against V widened to fp32 (no rounding
of ``p``), normalisation after p·v.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from livecc_tpu_torch.ops import build
from livecc_tpu_torch.ops.attention import NEG_INF


def _layer(k: torch.Tensor, v: torch.Tensor, layer_index):
    """One layer of a stacked cache (K/V ``[L, B, Hk, Smax, D]`` or scales
    ``[L, B, Hk, 1, Smax]``): a view, never a copy."""
    if k.ndim == 5:
        if layer_index is None:
            raise ValueError("a stacked [L, B, Hk, ...] cache needs a layer_index")
        return k[int(layer_index)], v[int(layer_index)]
    return k, v


def _scores(q: torch.Tensor, k: torch.Tensor, k_scale) -> torch.Tensor:
    """fp32 ``q·k * d**-0.5`` over the whole cache, q heads grouped per KV
    head; an int8 cache multiplies each key column by its scale after."""
    g = q.shape[1] // k.shape[1]
    s = torch.matmul(q.float(), k.repeat_interleave(g, dim=1).float().transpose(-1, -2))
    s = s * q.shape[-1] ** -0.5                                          # [B, Hq, Sq, Smax]
    if k_scale is not None:
        s = s * k_scale.repeat_interleave(g, dim=1).float()              # [B, Hq, 1, Smax]
    return s


def _masked_softmax_pv(s: torch.Tensor, allowed: torch.Tensor, v: torch.Tensor,
                       out_dtype, v_scale=None) -> torch.Tensor:
    """Kernel numerics: fp32 scores, ``l`` summed before any value scale,
    probabilities rounded to v's dtype for the p·v product (an int8 cache:
    scaled per key and kept fp32), normalisation after it, 0 for a row with
    no valid key."""
    g = s.shape[1] // v.shape[1]
    vv = v.repeat_interleave(g, dim=1)
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.repeat_interleave(g, dim=1).float()
    else:
        p = p.to(v.dtype).float()
    o = torch.matmul(p, vv.float())
    return (o / torch.where(l > 0, l, torch.ones_like(l))).to(out_dtype)


def _check_scales(name: str, k, v, k_scale, v_scale) -> None:
    """Raise on what the int8 kernels do not take."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: pass both k_scale and v_scale, or neither")
    if k_scale is None:
        return
    b, hk, smax, _ = k.shape
    for t, what in ((k, "k"), (v, "v")):
        if t.dtype != torch.int8:
            raise TypeError(f"{name}: a scaled cache must be int8, got {what} {t.dtype}")
    for t in (k_scale, v_scale):
        if t.shape != (b, hk, 1, smax) or t.dtype != torch.bfloat16 or t.stride(-1) != 1:
            raise ValueError(f"{name}: scales must be bf16 [B, Hk, 1, Smax] = "
                             f"{(b, hk, 1, smax)} with unit-stride positions, got "
                             f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")


def _check_int8_rows(name: str, q, out, k, v, k_scale, v_scale) -> None:
    """What bf16 K1-int8 (``csrc/quant_mma_attention.cuh``) takes besides
    ``_check_cuda_operands``: bf16 q and output rows as
    ``build.check_bf16_rows`` says, int8 K/V rows whose 16-byte copies are
    aligned (base and the stride of every dim of more than one entry but the
    last a multiple of 16 bytes) and scale rows likewise (``Smax * 2``
    bytes a multiple of 16 for a contiguous cache)."""
    build.check_bf16_rows(name, q, out)
    for t, size in ((k, 1), (v, 1), (k_scale, 2), (v_scale, 2)):
        if t.data_ptr() % 16 or any(s * size % 16 for s, n in zip(t.stride()[:-1], t.shape[:-1])
                                    if n > 1):
            raise ValueError(f"{name}: int8 K/V and scale rows must be 16-byte aligned, got "
                             f"{t.dtype} base {t.data_ptr() % 16} mod 16 and strides {t.stride()}")


def _check_cuda_operands(name: str, q, k, v, k_scale, v_scale) -> None:
    if k_scale is None:
        build.check_operands(name, q, k, v)
        return
    build.check_operands(name, q)
    for t in (k, v, k_scale, v_scale):
        if t.device != q.device:
            raise ValueError(f"{name}: operands on {t.device} and {q.device}")
    for t in (k, v):
        if t.shape[-1] != q.shape[-1] or t.stride(-1) != 1:
            raise ValueError(f"{name}: K/V head dim must match q's and be unit-stride, "
                             f"got {tuple(t.shape)} strides {t.stride()}")


# ---------------------------------------------------------------------------
# K1: prefill
# ---------------------------------------------------------------------------

def flash_prefill_plain(q, k, v, offset, kv_limit, k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain version of K1 (int8 with scales) on a one-layer cache ``[B, Hk,
    Smax, D]``. V's rows at or past a row's ``kv_limit`` are read as zeros,
    as the kernels read them, so whatever the cache holds there (a NaN
    never meets p = 0) leaves the output as it is."""
    b, _, sq, _ = q.shape
    smax = k.shape[2]
    _check_scales("flash_prefill", k, v, k_scale, v_scale)
    offset = build.row_scalars(offset, b, q.device)
    kv_limit = build.row_scalars(kv_limit, b, q.device)
    s = _scores(q, k, k_scale)
    qpos = offset[:, None] + torch.arange(sq, device=q.device)[None, :]     # [B, Sq]
    kpos = torch.arange(smax, device=q.device)
    v = v.masked_fill((kpos[None, :] >= kv_limit[:, None])[:, None, :, None], 0)
    allowed = (kpos[None, None, :] <= qpos[:, :, None]) & (
        kpos[None, None, :] < kv_limit[:, None, None])                      # [B, Sq, Smax]
    return _masked_softmax_pv(s, allowed[:, None], v, q.dtype, v_scale)


# bf16 K1's grid (csrc/wgmma_attention.cuh): query rows a block (kWgRows),
# keys a tile (kWgKeys), the key splits a query tile at most, and the SMs
# the split fills (the H100 SXM's 132; a fixed number, so the split and the
# output's bits do not depend on the card)
PREFILL_ROWS = 128
PREFILL_KEYS = 64
PREFILL_MAX_SPLIT = 16
PREFILL_SMS = 132


@functools.lru_cache(maxsize=256)
def prefill_plan(batch: int, hq: int, hk: int, sq: int) -> tuple[int, int, int]:
    """bf16 K1's grid from its shape alone: (queries a tile, query tiles,
    key splits a tile). A tile packs the G = Hq / Hk query heads of one KV
    head into its 128 rows, ``128 // G`` whole queries (18 at G = 7); the
    keys of each tile are split across as many blocks as fill 132 SMs, at
    most ``PREFILL_MAX_SPLIT``. Offsets and limits stay on the device:
    ``prefill_span`` says how many of the splits a tile uses. The split
    follows the shape, so the same row at the same depth may round apart
    at another Sq or batch size."""
    qt = PREFILL_ROWS // (hq // hk)
    tiles = -(-sq // qt)
    return qt, tiles, max(1, min(PREFILL_MAX_SPLIT, PREFILL_SMS // (tiles * hk * batch)))


def prefill_span(kv_end: int, nsplit: int) -> tuple[int, int, int]:
    """(key tiles, key tiles a split, live splits) of a query tile whose keys
    end at ``kv_end`` = min(kv_limit, Smax, offset + the tile's last query
    + 1): ``prefill_span`` of csrc/wgmma_attention.cuh. Split s walks the
    key tiles [s * per, min(n, (s + 1) * per)); a tile with no valid key
    has no live split, and its first block writes zeros."""
    n = -(-kv_end // PREFILL_KEYS) if kv_end > 0 else 0
    per = max(1, -(-n // nsplit))
    return n, per, -(-n // per)


@functools.lru_cache(maxsize=64)
def _cache_maps(k_ptr: int, v_ptr: int, shape: tuple, k_stride: tuple,
                v_stride: tuple) -> ctypes.Array:
    """bf16 K1's tensor maps of a cache's K and V (two CUtensorMap, 256
    bytes) over ``[L, B, Hk, Smax, D]`` (a one-layer cache as L = 1), the
    layer a coordinate (``livecc_prefill_kv_map``): encoded once per
    address, shape and strides, which are all a map holds."""
    if len(shape) == 4:
        shape, k_stride, v_stride = (1, *shape), (0, *k_stride), (0, *v_stride)
    lib = build.load_library()
    maps = ctypes.create_string_buffer(256)
    for i, (ptr, stride) in enumerate(((k_ptr, k_stride), (v_ptr, v_stride))):
        err = lib.livecc_prefill_kv_map(ptr, *shape, (ctypes.c_longlong * 4)(*stride[:4]),
                                        ctypes.addressof(maps) + 128 * i)
        if err != 0:
            raise RuntimeError(f"flash_prefill: the driver refused a tensor map of the cache "
                               f"{shape} strides {stride} (cudaError_t {err})")
    return maps


def flash_prefill(
    q: torch.Tensor,            # [B, Hq, Sq, D]
    k: torch.Tensor,            # [B, Hk, Smax, D] or [L, B, Hk, Smax, D] (layer_index)
    v: torch.Tensor,
    offset,                     # int or int32 [B] — queries start here (per row)
    kv_limit,                   # int or int32 [B] — keys < kv_limit valid (per row)
    layer_index: int | None = None,
    k_scale: torch.Tensor | None = None,   # int8 cache: [..., Hk, 1, Smax] bf16
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Chunk queries appended at ``offset`` attend causally over the cache."""
    cache_k, cache_v = k, v
    k, v = _layer(k, v, layer_index)
    if k_scale is not None:
        k_scale, v_scale = _layer(k_scale, v_scale, layer_index)
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, offset, kv_limit, k_scale, v_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_prefill: no kernel for device {q.device}")
    b, hq, sq, d = q.shape
    hk, smax = k.shape[1], k.shape[2]
    if k.shape != (b, hk, smax, d) or v.shape != k.shape or hq % hk:
        raise ValueError(f"flash_prefill: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    _check_scales("flash_prefill", k, v, k_scale, v_scale)
    _check_cuda_operands("flash_prefill", q, k, v, k_scale, v_scale)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if k_scale is None:
        build.check_bf16_rows("flash_prefill", q, k, v, out)
    elif q.dtype == torch.bfloat16:
        _check_int8_rows("flash_prefill", q, out, k, v, k_scale, v_scale)
    offset = build.row_scalars(offset, b, q.device)
    kv_limit = build.row_scalars(kv_limit, b, q.device)
    lib = build.load_library()
    strides = [(q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)), (out, (0, 1, 2))]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if k_scale is None:
            maps, layer, workspace, nsplit = None, 0, None, 1
            if q.dtype == torch.bfloat16:
                maps = _cache_maps(cache_k.data_ptr(), cache_v.data_ptr(), tuple(cache_k.shape),
                                   cache_k.stride(), cache_v.stride())
                layer = 0 if cache_k.ndim == 4 else int(layer_index)
                _, tiles, nsplit = prefill_plan(b, hq, hk, sq)
                if nsplit > 1:
                    workspace = torch.empty(b * hk * tiles * nsplit * PREFILL_ROWS * (d + 2),
                                            dtype=torch.float32, device=q.device)
            build.launch(
                "flash_prefill", lib.livecc_flash_prefill,
                build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), offset.data_ptr(), kv_limit.data_ptr(),
                b, hq, hk, sq, smax, d, build.stride_array(*strides), d ** -0.5, maps, layer,
                None if workspace is None else workspace.data_ptr(), nsplit, stream,
            )
        else:
            build.launch(
                "flash_prefill_int8", lib.livecc_flash_prefill_int8,
                build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(),
                out.data_ptr(), offset.data_ptr(), kv_limit.data_ptr(),
                b, hq, hk, sq, smax, d,
                build.stride_array(*strides, (k_scale, (0, 1)), (v_scale, (0, 1))),
                d ** -0.5, stream,
            )
    return out


# ---------------------------------------------------------------------------
# K2: decode
# ---------------------------------------------------------------------------

def _past_limit_zeroed(v, v_scale, valid):
    """V ``[B, Hk, Smax, D]`` and an int8 cache's v_scale ``[B, Hk, 1, Smax]``
    with the positions past each row's limit (``valid`` [B, Smax] false)
    read as zeros, as the decode kernel never reads them: whatever the cache
    holds there (a NaN never meets p = 0) leaves the output as it is."""
    v = v.masked_fill(~valid[:, None, :, None], 0)
    if v_scale is not None:
        v_scale = v_scale.masked_fill(~valid[:, None, None, :], 0)
    return v, v_scale


def flash_decode_plain(q, k, v, kv_limit, k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain version of K2 (int8 with scales) on a one-layer cache ``[B, Hk,
    Smax, D]``; V (and v_scale) past a row's ``kv_limit`` read as zeros."""
    b = q.shape[0]
    smax = k.shape[2]
    _check_scales("flash_decode", k, v, k_scale, v_scale)
    kv_limit = build.row_scalars(kv_limit, b, q.device)
    s = _scores(q, k, k_scale)                                               # [B, Hq, 1, Smax]
    allowed = torch.arange(smax, device=q.device)[None, :] < kv_limit[:, None]   # [B, Smax]
    v, v_scale = _past_limit_zeroed(v, v_scale, allowed)
    return _masked_softmax_pv(s, allowed[:, None, None, :], v, q.dtype, v_scale)


def flash_decode_split_plain(q, k, v, kv_limit, split: int, k_scale=None, v_scale=None):
    """The split kernel's partials in PyTorch, on a one-layer cache: for each
    split of ``split`` keys, ``m`` (max score) and ``l`` (sum of p) ``[B, Hq,
    nsplit]`` and ``acc`` (p·v) ``[B, Hq, nsplit, D]``, fp32, with p = exp(s -
    m) within the split, ``l`` taken before any rounding or value scale, p
    rounded to v's dtype for p·v (an int8 cache: scaled per key, fp32); V
    and v_scale past a row's limit read as zeros. A split with no valid key:
    m = -inf, l = 0, acc = 0. Tests only: the CPU route of ``flash_decode``
    is ``flash_decode_plain``."""
    b, hq = q.shape[:2]
    hk, smax, d = k.shape[1:]
    g = hq // hk
    _check_scales("flash_decode", k, v, k_scale, v_scale)
    kv_limit = build.row_scalars(kv_limit, b, q.device)
    v, v_scale = _past_limit_zeroed(
        v, v_scale, torch.arange(smax, device=q.device)[None, :] < kv_limit[:, None])
    nsplit = -(-smax // split)
    pad = nsplit * split - smax
    s = torch.matmul(q.float().reshape(b, hk, g, d), k.float().transpose(-1, -2)) * d ** -0.5
    if k_scale is not None:
        s = s * k_scale.float()                                            # [B, Hk, G, Smax]
    allowed = torch.arange(nsplit * split, device=q.device)[None, :] < kv_limit[:, None]
    allowed = allowed.reshape(b, 1, 1, nsplit, split)
    s = torch.nn.functional.pad(s, (0, pad)).reshape(b, hk, g, nsplit, split)
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1)
    if v_scale is not None:
        p = p * torch.nn.functional.pad(v_scale.float(), (0, pad)).reshape(b, hk, 1, nsplit, split)
    else:
        p = p.to(v.dtype).float()
    vs = torch.nn.functional.pad(v.float(), (0, 0, 0, pad)).reshape(b, hk, nsplit, split, d)
    acc = torch.einsum("bhgns,bhnsd->bhgnd", p, vs)                        # [B, Hk, G, nsplit, D]
    empty = ~allowed.any(dim=-1)                                           # [B, 1, 1, nsplit]
    m = torch.where(empty, torch.full_like(l, float("-inf")), m[..., 0])
    return m.reshape(b, hq, nsplit), l.reshape(b, hq, nsplit), acc.reshape(b, hq, nsplit, d)


def flash_decode_merge_plain(m, l, acc, out_dtype) -> torch.Tensor:
    """The merge kernel in PyTorch: ``sum_i e^(m_i - M) acc_i / sum_i
    e^(m_i - M) l_i`` over the non-empty splits (l > 0), ``[B, Hq, 1, D]``;
    0 for a row whose splits are all empty."""
    valid = l > 0
    mv = torch.where(valid, m, torch.full_like(m, NEG_INF))
    big = mv.amax(dim=-1, keepdim=True)
    w = torch.where(valid, torch.exp(torch.where(valid, m, big) - big), torch.zeros_like(m))
    den = (w * l).sum(dim=-1, keepdim=True)
    o = (w[..., None] * acc).sum(dim=-2)
    o = o / torch.where(den > 0, den, torch.ones_like(den))
    return o[:, :, None].to(out_dtype)


# keys per split block of the K2 / K2-int8 kernel: ``kDecSplit`` of
# csrc/decode_attention.cuh, which refuses a workspace sized for another split
DECODE_SPLIT = 256
# query heads x head dim one decode block takes: ``kDecMaxOut`` of the same header
DECODE_MAX_GD = 2048


def decode_subgroups(g: int, d: int) -> list[tuple[int, int]]:
    """The query heads ``[lo, hi)`` of each KV head's group of ``g`` that one
    launch of the decode kernels takes: the whole group while G·D <= 2048,
    else contiguous runs of at most 2048 // D heads."""
    per = max(1, DECODE_MAX_GD // d)
    return [(lo, min(lo + per, g)) for lo in range(0, g, per)]


def by_subgroups(q: torch.Tensor, hk: int, groups, attend) -> torch.Tensor:
    """Decode attention of q ``[B, Hq, 1, D]`` one sub-group at a time:
    ``attend`` gets each sub-group's heads of every KV head as a contiguous
    ``[B, Hk * n, 1, D]`` (head j of KV head i at i * n + j, so the KV head
    of a head is still its index // n) and returns their output, which is
    written back into place."""
    b, hq, _, d = q.shape
    g = hq // hk
    out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    qg, og = q.unflatten(1, (hk, g)), out.unflatten(1, (hk, g))
    for lo, hi in groups:
        part = attend(qg[:, :, lo:hi].reshape(b, hk * (hi - lo), 1, d).contiguous())
        og[:, :, lo:hi] = part.unflatten(1, (hk, hi - lo))
    return out


def flash_decode(
    q: torch.Tensor,            # [B, Hq, 1, D]
    k: torch.Tensor,            # [B, Hk, Smax, D] or [L, B, Hk, Smax, D] (layer_index)
    v: torch.Tensor,
    kv_limit,                   # int or int32 [B] — keys < kv_limit valid (per row)
    layer_index: int | None = None,
    k_scale: torch.Tensor | None = None,   # int8 cache: [..., Hk, 1, Smax] bf16
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """One query token per row over the cache; q heads grouped per KV head.
    On the GPU one kernel launch on the caller's stream: its split blocks
    write their partials into a workspace allocated here, and the last of a
    row's split blocks merges them into the output (``_arrival_counters``).
    A group wider than one decode block
    (G·D > 2048, e.g. Hq = 32 over one KV head at D = 128) runs as
    ``decode_subgroups``: one such call per sub-group, each counted as a
    launch, with the sub-group's q copied to a contiguous buffer and its
    output copied back into place."""
    cache_k, cache_v = k, v
    k, v = _layer(k, v, layer_index)
    if k_scale is not None:
        k_scale, v_scale = _layer(k_scale, v_scale, layer_index)
    if q.shape[2] != 1:
        raise ValueError(f"flash_decode: one query token per row, got q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_limit, k_scale, v_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_decode: no kernel for device {q.device}")
    b, hq, _, d = q.shape
    hk, smax = k.shape[1], k.shape[2]
    if k.shape != (b, hk, smax, d) or v.shape != k.shape or hq % hk:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    _check_scales("flash_decode", k, v, k_scale, v_scale)
    _check_cuda_operands("flash_decode", q, k, v, k_scale, v_scale)
    kv_limit = build.row_scalars(kv_limit, b, q.device)
    maps, layer = None, 0
    if _decode_tma(q, cache_k, cache_v, k_scale, v_scale):
        maps = _decode_maps(cache_k.data_ptr(), cache_v.data_ptr(), tuple(cache_k.shape),
                            cache_k.stride(), cache_v.stride(), cache_k.element_size())
        layer = 0 if cache_k.ndim == 4 else int(layer_index)
    groups = decode_subgroups(hq // hk, d)
    if len(groups) == 1:
        return _decode_launch(q, k, v, kv_limit, k_scale, v_scale, maps, layer)
    return by_subgroups(q, hk, groups, lambda qs: _decode_launch(qs, k, v, kv_limit, k_scale,
                                                                 v_scale, maps, layer))


# the decode kernel's arrival counters, one int32 per (row, KV head), by
# device: every buffer ever made (a captured graph keeps the address it saw)
_COUNTERS: dict[torch.device, list[torch.Tensor]] = {}
_COUNTERS_MIN = 4096


def _arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    """The device's decode arrival counters, at least ``n``: made zeroed on
    the current stream at the first launch that needs them, before the
    launch (the decode graphs run an eager step before they capture, so
    the buffer exists by then), and left zero by every launch. A larger
    batch makes a larger buffer; the old one is kept, since a captured
    graph may still use it."""
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    kept = _COUNTERS.setdefault(device, [])
    if not kept or kept[-1].numel() < n:
        kept.append(torch.zeros(max(n, _COUNTERS_MIN, 2 * kept[-1].numel() if kept else 0),
                                dtype=torch.int32, device=device))
    return kept[-1]


def _aligned16(t: torch.Tensor) -> bool:
    """Base and the byte stride of every dim of more than one entry but the
    last a multiple of 16 (what TMA and 16-byte copies need)."""
    return t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0
                                          for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)


def _decode_tma(q, cache_k, cache_v, k_scale, v_scale) -> bool:
    """Whether the decode kernel's ring is filled by TMA: bf16 q over a bf16
    cache of D = 64 or 128, or an int8 cache of D = 128 (one or two
    128-byte boxes a row), 16-byte aligned rows and, for int8, scale rows
    (Smax a multiple of 8); else it takes cp.async pieces."""
    row_bytes = cache_k.shape[-1] * cache_k.element_size()
    ok = (q.dtype == torch.bfloat16 and row_bytes in (128, 256) and cache_k.stride(-1) == 1
          and cache_v.stride(-1) == 1 and _aligned16(cache_k) and _aligned16(cache_v))
    if ok and k_scale is not None:
        ok = cache_k.shape[-2] % 8 == 0 and _aligned16(k_scale) and _aligned16(v_scale)
    return ok


@functools.lru_cache(maxsize=64)
def _decode_maps(k_ptr: int, v_ptr: int, shape: tuple, k_stride: tuple, v_stride: tuple,
                 elem_bytes: int) -> ctypes.Array:
    """The decode kernel's tensor maps of a cache's K and V (two CUtensorMap,
    256 bytes) over ``[L, B, Hk, Smax, D]`` (a one-layer cache as L = 1),
    the layer a coordinate (``livecc_decode_kv_map``): encoded once per
    address, shape and strides, all a map holds. A CUDA graph captured
    around the kernel keeps them by value (ROADMAP hazards)."""
    if len(shape) == 4:
        shape, k_stride, v_stride = (1, *shape), (0, *k_stride), (0, *v_stride)
    lib = build.load_library()
    maps = ctypes.create_string_buffer(256)
    for i, (ptr, stride) in enumerate(((k_ptr, k_stride), (v_ptr, v_stride))):
        stride = [0 if n == 1 else s for s, n in zip(stride[:4], shape[:4])]
        err = lib.livecc_decode_kv_map(ptr, *shape, (ctypes.c_longlong * 4)(*stride),
                                       elem_bytes, ctypes.addressof(maps) + 128 * i)
        if err != 0:
            raise RuntimeError(f"flash_decode: the driver refused a tensor map of the cache "
                               f"{shape} strides {stride} (cudaError_t {err})")
    return maps


def _decode_launch(q, k, v, kv_limit, k_scale, v_scale, maps, layer) -> torch.Tensor:
    """One launch of the decode kernel (G·D <= 2048) into a new output; with
    ``maps`` (``_decode_maps``) its ring is filled by TMA from ``layer``."""
    b, hq, _, d = q.shape
    hk, smax = k.shape[1], k.shape[2]
    out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    nsplit = -(-smax // DECODE_SPLIT)
    workspace = torch.empty((2 + d) * b * hq * nsplit, dtype=torch.float32, device=q.device)
    counters = _arrival_counters(q.device, b * hk)
    lib = build.load_library()
    strides = [(q, (0, 1)), (k, (0, 1, 2)), (v, (0, 1, 2)), (out, (0, 1))]
    with build.on_device(q.device):
        stream = build.current_stream(q.device)
        if k_scale is None:
            build.launch(
                "flash_decode", lib.livecc_flash_decode,
                build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), kv_limit.data_ptr(), b, hq, hk, smax, d,
                build.stride_array(*strides), d ** -0.5, workspace.data_ptr(),
                counters.data_ptr(), nsplit, maps, layer, stream,
            )
        else:
            build.launch(
                "flash_decode_int8", lib.livecc_flash_decode_int8,
                build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(),
                out.data_ptr(), kv_limit.data_ptr(), b, hq, hk, smax, d,
                build.stride_array(*strides, (k_scale, (0, 1)), (v_scale, (0, 1))),
                d ** -0.5, workspace.data_ptr(), counters.data_ptr(), nsplit, maps, layer,
                stream,
            )
    return out

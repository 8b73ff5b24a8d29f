"""Hold the decode kernels (K2, K2-int8) to their plain version, by a limit
that a dropped split of keys fails.

``close(out, ref, dtype)`` compares a kernel's output with the plain version
on the same inputs in the same dtype (``flash_decode_plain`` on the bf16
tensors rounds p to bf16 as the kernel does): elementwise

    |out - ref| <= rtol * |ref| + atol * rms(ref's row)

with bf16 (1e-2, 2e-2) and fp32 (1e-4, 1e-4), the limits of the K4 check
in ``chip_smoke.py``. bf16's rtol is just above one bf16 step (2^-7
relative), all that a rounding flip moves an output. The rms is taken over
each output row (the last dim, one query head of one batch row), since
rows at different cache depths differ in scale by orders of magnitude: a
row over one key is a V row (~1), one over 8192 keys ~0.05. It returns the
worst share of the limit used; above 1 fails.

``drop_split(...)`` is the planted fault: the plain version with the keys
``[split, 2 * split)`` of the longest row removed for one KV head's query
heads, what a kernel that skipped one split block would give. A check
that passes it could not see a lost split.
"""

from __future__ import annotations

import torch

from livecc_tpu_torch.ops import build
from livecc_tpu_torch.ops.flash_attention import _masked_softmax_pv, _scores

TOL = {torch.bfloat16: (1e-2, 2e-2), torch.float32: (1e-4, 1e-4)}


def close(out: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype) -> float:
    """Worst share of the limit ``rtol |ref| + atol rms(row of ref)`` that
    ``|out - ref|`` uses (<= 1 passes). Raises on a shape mismatch or a
    non-finite output."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"shape {tuple(out.shape)} vs {tuple(ref.shape)} or non-finite output")
    rtol, atol = TOL[dtype]
    lim = rtol * ref.abs() + atol * ref.square().mean(dim=-1, keepdim=True).sqrt()
    diff = (out - ref).abs()
    share = torch.where(diff == 0, torch.zeros_like(diff), diff / lim)
    return share.max().item()


def drop_split(q, k, v, kv_limit, split: int, k_scale=None, v_scale=None,
               kv_head: int = 0) -> torch.Tensor:
    """``flash_decode_plain`` on a one-layer cache with the keys ``[split,
    2 * split)`` of the longest row left out for the query heads of
    ``kv_head`` (int8 with scales)."""
    b, hq = q.shape[:2]
    hk, smax = k.shape[1], k.shape[2]
    g = hq // hk
    lim = build.row_scalars(kv_limit, b, q.device)
    row = int(lim.argmax())
    if min(int(lim[row]), smax) <= split:
        raise ValueError(f"drop_split: the longest row ({int(lim[row])} keys) has one split "
                         f"of {split} or less")
    allowed = torch.arange(smax, device=q.device)[None, :] < lim[:, None]
    allowed = allowed[:, None, None, :].expand(b, hq, 1, smax).clone()
    allowed[row, kv_head * g:(kv_head + 1) * g, :, split:2 * split] = False
    return _masked_softmax_pv(_scores(q, k, k_scale), allowed, v, q.dtype, v_scale)

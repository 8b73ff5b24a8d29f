"""``jax.image.resize`` in PyTorch, for the methods the detectors reach.

The JAX package resizes feature maps with ``jax.image.resize`` (SCRFD's
top-down FPN, ``livecc_tpu/tools/scrfd.py:119``; ONNX Resize / Upsample,
``livecc_tpu/tools/onnx_jax.py:146-163``). Torch's ``F.interpolate`` modes
compute other values:

  * ``"nearest"`` in JAX samples pixel centres, ``floor((i + 0.5) * m / n)``
    (torch's ``nearest-exact``, not its ``nearest``, which floors ``i * m / n``);
  * ``"cubic"`` is Keys' kernel with a = -0.5 (torch's ``bicubic``: -0.75);
  * ``"linear"`` (and ``"cubic"``) widen the kernel by the scale when
    downsampling (antialiasing, JAX's default), which torch's ``bilinear``
    does not.

So this module builds JAX's separable weight matrices
(``jax._src.image.scale.compute_weight_mat`` with ``_fill_triangle_kernel``
or ``_fill_keys_cubic_kernel``) in float32 on the input's device and
applies them one axis at a time as products; nearest is an index gather
with JAX's float32 offsets. Like JAX, every axis whose size changes is
resized, batch and channel axes included. Nothing is copied from the host:
the indices and weights are made on the device, so a call never waits for it.
"""

from __future__ import annotations

from typing import Sequence

import torch

_METHODS = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
            "cubic": "cubic", "bicubic": "cubic"}


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1 - torch.abs(x), min=0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel, a = -0.5 (x >= 0)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = torch.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return torch.where(x >= 2., torch.zeros_like(x), out)


def weight_matrix(m: int, n: int, method: str, device=None) -> torch.Tensor:
    """[m, n] float32 weights taking an axis of ``m`` samples to ``n``
    (``compute_weight_mat`` at scale n / m, translation 0, antialiased)."""
    kernel = _triangle if _METHODS[method] == "linear" else _keys_cubic
    inv_scale = 1. / (n / m)
    kernel_scale = max(inv_scale, 1.)
    f32 = torch.float32
    sample_f = (torch.arange(n, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(m, dtype=f32, device=device)[:, None]) \
        / kernel_scale
    weights = kernel(x)
    total = torch.sum(weights, dim=0, keepdim=True)
    eps = 1000. * torch.finfo(f32).eps
    weights = torch.where(torch.abs(total) > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def nearest_indices(m: int, n: int, device=None) -> torch.Tensor:
    """[n] int64: the input sample of each output sample (JAX's
    ``_resize_nearest``, offsets in float32)."""
    offsets = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * m / n
    return torch.floor(offsets).to(torch.int64)


def resize(x: torch.Tensor, shape: Sequence[int], method: str) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` (antialias on, its default)
    for ``method`` in nearest, linear / bilinear, cubic / bicubic."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"resize: shape {shape} does not match the input's rank {x.ndim}")
    kind = _METHODS.get(method)
    if kind is None:
        raise ValueError(f"resize: method {method!r} (nearest, linear or cubic)")
    if kind != "nearest" and not x.is_floating_point():
        x = x.to(torch.float32)
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        if kind == "nearest":
            x = x.index_select(d, nearest_indices(m, n, x.device))
        else:
            w = weight_matrix(m, n, kind, x.device).to(x.dtype)
            x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x

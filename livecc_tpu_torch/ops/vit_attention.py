"""K3 ``vit_group_attention``: full attention within ViT temporal groups.

Port of ``livecc_tpu/ops/pallas/vit_attention.py`` (forward). Two forms,
one kernel (``csrc/vit_attention.cu``), which takes segment bounds:

  * ``vit_group_attention(q, k, v)`` on ``[NG, g, H, D]``, NG uniform groups
    of g patches (every single-video path, so the whole streaming path);
  * ``vit_segment_attention(q, k, v, cu_seqlens, max_len)`` on ``[N, H, D]``
    with segments of any sizes (mixed grids in one tower call), the JAX
    tower's segment-mask ``mha`` (``livecc_tpu/models/qwen2_vl/vision.py:121``);
    ``segment_bounds`` turns its segment ids into bounds.

CUDA tensors go to the kernel, CPU tensors to the plain versions below; any
other device raises. bf16 runs on Hopper's warpgroup products
(``csrc/wgmma_attention.cuh``: head dim a multiple of 16, rows 16-byte
aligned), fp32 on the FMA pipes. There is no ``MAX_GROUP``:
the kernel streams key tiles. ``build.launch_counts["vit_group_attention"]``
counts every K3 launch, of either form.

On CUDA both forms are differentiable through ``_K3``, an autograd
``Function`` whose forward is the kernel and whose backward recomputes the
plain version and takes its vjp, as JAX's ``custom_vjp`` takes ``mha``'s
(``livecc_tpu/ops/pallas/vit_attention.py:126-151``): an unfrozen ViT trains
with the attention gradient. The backward is plain PyTorch (JAX's is XLA).
"""

from __future__ import annotations

import functools

import torch

from livecc_tpu_torch.ops import build


def vit_group_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: fp32 scores and softmax, unnormalised
    probabilities rounded to v's dtype for the p·v product, normalisation
    after it (the TPU kernel's order)."""
    d = q.shape[-1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))            # [NG, H, g, D]
    s = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * d ** -0.5
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e.to(v.dtype).float(), vt.float()) / l
    return o.to(q.dtype).transpose(1, 2)


def vit_segment_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                cu_seqlens) -> torch.Tensor:
    """Plain version of the bounds form: ``vit_group_attention_plain`` on
    each segment ``[cu[i], cu[i + 1])`` of ``[N, H, D]``."""
    bounds = [int(x) for x in cu_seqlens]
    out = torch.empty_like(q)
    for a, b in zip(bounds[:-1], bounds[1:]):
        out[a:b] = vit_group_attention_plain(q[None, a:b], k[None, a:b], v[None, a:b])[0]
    return out


def segment_bounds(seg_ids) -> tuple[list[int], int]:
    """(cu_seqlens, longest run) of the runs of equal ids in ``seg_ids`` [N].

    The JAX tower attends where ids are equal; that is attention within each
    run only while no id recurs in a later run, so a recurring id raises.
    One run of pad ids (< 0) at the end is an ordinary segment, as in JAX.
    It reads the ids on the host: the mixed-size path calls it once per
    tower call; the uniform path (every serving call) never does."""
    ids = torch.as_tensor(seg_ids).reshape(-1).cpu()
    n = ids.numel()
    if n == 0:
        raise ValueError("segment_bounds: no segment ids")
    starts = [0] + (torch.nonzero(ids[1:] != ids[:-1]).reshape(-1) + 1).tolist()
    run_ids = ids[starts].tolist()
    if len(set(run_ids)) != len(run_ids):
        raise ValueError(f"segment_bounds: a segment id recurs in a later run ({run_ids}); "
                         f"its equality mask would join the runs")
    cu = starts + [n]
    return cu, max(b - a for a, b in zip(cu[:-1], cu[1:]))


@functools.lru_cache(maxsize=64)
def _uniform_bounds(ng: int, g: int, device: torch.device) -> torch.Tensor:
    """int32 [ng + 1] = 0, g, ..., ng * g on ``device``, made there (no
    host sync) once per (ng, g, device)."""
    return torch.arange(0, (ng + 1) * g, g, dtype=torch.int32, device=device)


def _launch(q, k, v, out, cu: torch.Tensor, nseg: int, max_len: int) -> None:
    """K3 over ``[N, H, D]`` views and device bounds ``cu``."""
    d = q.shape[-1]
    lib = build.load_library()
    with build.on_device(q.device):
        build.launch(
            "vit_group_attention", lib.livecc_vit_attention,
            build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), cu.data_ptr(), nseg, max_len, q.shape[0], q.shape[1], d,
            build.stride_array((q, (0, 1)), (k, (0, 1)), (v, (0, 1)), (out, (0, 1))),
            d ** -0.5, build.current_stream(q.device),
        )


class _K3(torch.autograd.Function):
    """``run(q, k, v)`` (a K3 launch) forward; the vjp of ``plain(q, k, v)``,
    recomputed on the saved inputs, backward."""

    @staticmethod
    def forward(ctx, run, plain, q, k, v):
        ctx.plain = plain
        ctx.save_for_backward(q, k, v)
        return run(q, k, v)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        leaves = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.plain(*leaves)
        return (None, None, *torch.autograd.grad(out, leaves, grad))


def vit_group_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[NG, g, H, D] -> [NG, g, H, D], bidirectional within each group. On
    the GPU the kernel gets evenly spaced bounds, cached on the device, so a
    call allocates only its output."""
    if q.device.type == "cpu":
        return vit_group_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise RuntimeError(f"vit_group_attention: no kernel for device {q.device}")
    ng, g, h, d = q.shape
    build.check_operands("vit_group_attention", q, k, v)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"vit_group_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")

    def run(q, k, v):
        qn, kn, vn = (x.reshape(ng * g, h, d) for x in (q, k, v))
        build.check_bf16_rows("vit_group_attention", qn, kn, vn)
        out = torch.empty((ng * g, h, d), dtype=q.dtype, device=q.device)
        _launch(qn, kn, vn, out, _uniform_bounds(ng, g, q.device), ng, g)
        return out.view(ng, g, h, d)

    return _K3.apply(run, vit_group_attention_plain, q, k, v)


def vit_segment_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cu_seqlens: torch.Tensor, max_len: int) -> torch.Tensor:
    """[N, H, D] -> [N, H, D], bidirectional within each segment
    ``[cu_seqlens[i], cu_seqlens[i + 1])``: int32 bounds on q's device (from
    ``segment_bounds``, made once per tower call) and the longest segment
    ``max_len`` as a host int. The CPU checks the bounds; the GPU trusts them
    (reading them back would sync)."""
    if q.device.type == "cpu":
        cu = [int(x) for x in cu_seqlens]
        lengths = [b - a for a, b in zip(cu[:-1], cu[1:])]
        if not lengths or cu[0] != 0 or cu[-1] != q.shape[0] or min(lengths) <= 0 or (
                max(lengths) != max_len):
            raise ValueError(f"vit_segment_attention: bounds {cu} (longest {max_len}) do not "
                             f"split {q.shape[0]} rows")
        return vit_segment_attention_plain(q, k, v, cu)
    if q.device.type != "cuda":
        raise RuntimeError(f"vit_segment_attention: no kernel for device {q.device}")
    build.check_operands("vit_group_attention", q, k, v)
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"vit_segment_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}, want [N, H, D]")
    if (cu_seqlens.dtype != torch.int32 or cu_seqlens.device != q.device or cu_seqlens.ndim != 1
            or not cu_seqlens.is_contiguous() or cu_seqlens.numel() < 2):
        raise ValueError(f"vit_segment_attention: cu_seqlens must be contiguous int32 [nseg + 1] "
                         f"on {q.device}, got {cu_seqlens.dtype} {tuple(cu_seqlens.shape)} on "
                         f"{cu_seqlens.device}")

    def run(q, k, v):
        build.check_bf16_rows("vit_group_attention", q, k, v)
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        _launch(q, k, v, out, cu_seqlens, cu_seqlens.numel() - 1, max_len)
        return out

    def plain(q, k, v):   # reads the bounds back: only a backward does
        return vit_segment_attention_plain(q, k, v, cu_seqlens.tolist())

    return _K3.apply(run, plain, q, k, v)

"""ONNX graph -> PyTorch function: the op subset detector CNNs use.

The port's counterpart of ``livecc_tpu/tools/onnx_jax.py``: executes a
``tools.onnx_lite.Model`` eagerly, in ONNX's native NCHW layout, on one
device. Same op set: Conv (incl. group/depthwise), BatchNormalization,
Relu/LeakyRelu/PRelu/Sigmoid, Add, Sub, Mul, Div, Concat,
MaxPool/AveragePool/GlobalAveragePool, Resize/Upsample, Reshape, Transpose,
Flatten, Gemm/MatMul, Softmax, Exp, Clip, Identity, Slice, Squeeze,
Shape/Gather/Unsqueeze/Constant.

It computes what the JAX executor computes, not what the ONNX spec says:

  * ``auto_pad`` SAME_UPPER and SAME_LOWER both pad as XLA's ``"SAME"``:
    total = max((ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0), the smaller
    half before. For stride 2 on an even side that is 0 before and 1 after,
    which ``F.conv2d(padding=...)`` cannot express: an uneven pad is an
    ``F.pad`` before an unpadded conv, an even one the conv's own padding;
    pools are always ``F.pad``-ed (``-inf`` for MaxPool).
  * AveragePool divides each window's sum by its count of unpadded cells.
  * Resize follows ``jax.image.resize`` (``ops/resize.py``) and ignores
    ``cubic_coeff_a``; Reshape does not read a 0 as "copy this dimension".
    Both, like SAME_LOWER padded as upper, are the JAX executor's defects,
    kept for parity (ROADMAP).

Shape chains (Shape -> Gather -> Unsqueeze -> Reshape, Constant) fold on
the host as numpy, as the JAX executor folds them at trace time, so a
Reshape never reads a device tensor. Initializers and Constant values go to
the device once, when the function is built, and BatchNormalization's
per-channel scale and shift are folded then (in float64, from the numpy
initializers). A call copies its inputs to the device, and besides them
only a value it folded on the host that a device op then reads (a Gather
index, a computed constant; none in buffalo_sc's layout); it never reads
a device tensor back.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from livecc_tpu_torch.ops.resize import resize
from livecc_tpu_torch.tools.onnx_lite import Model, Node
from livecc_tpu_torch.utils.device import device_for


def _pair(v, default):
    if v is None:
        return (default, default)
    v = tuple(int(x) for x in v)
    return v if len(v) == 2 else (v[0], v[0])


def same_pads(size: int, k: int, stride: int, dilation: int = 1) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def same_pads_hw(x: torch.Tensor, kernel_hw, strides, dilations=(1, 1)) -> tuple[int, ...]:
    """XLA's ``"SAME"`` padding of ``x`` [..., H, W] as (top, left, bottom, right)."""
    (t, b), (l, r) = (same_pads(n, k, s, d) for n, k, s, d in
                      zip(x.shape[-2:], kernel_hw, strides, dilations))
    return t, l, b, r


def pad_hw(x: torch.Tensor, pads, value: float = 0.0, conv: bool = False):
    """``x`` padded by ``pads`` (top, left, bottom, right). With ``conv``,
    returns (x, padding) for a conv op: even pads become the op's own
    zero ``padding`` (no extra launch), uneven ones an ``F.pad``."""
    t, l, b, r = pads
    if conv and t == b and l == r:
        return x, (t, l)
    x = F.pad(x, (l, r, t, b), value=value) if any(pads) else x
    return (x, 0) if conv else x


def pad_same(x: torch.Tensor, kernel_hw, strides, dilations=(1, 1),
             value: float = 0.0) -> torch.Tensor:
    """``x`` [..., H, W] padded as XLA's ``"SAME"`` pads it for this window."""
    return pad_hw(x, same_pads_hw(x, kernel_hw, strides, dilations), value)


def _pads(node: Node, x, kernel_hw, strides, dilations=(1, 1)) -> tuple[int, ...]:
    """(top, left, bottom, right) as ``onnx_jax._conv_padding`` pads ``x``."""
    auto = node.attr("auto_pad", b"NOTSET")
    auto = auto.decode() if isinstance(auto, bytes) else auto
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        return same_pads_hw(x, kernel_hw, strides, dilations)
    pads = node.attr("pads")
    return tuple(int(p) for p in pads) if pads else (0, 0, 0, 0)


def _const_int_list(v) -> list[int]:
    arr = np.asarray(v)
    return [int(x) for x in arr.reshape(-1)]


def build_fn(model: Model, device="cuda") -> Callable[..., list]:
    """Returns ``fn(*inputs) -> [outputs]`` executing the graph on
    ``device`` (inputs: tensors there, or numpy arrays, copied once)."""
    dev = device_for(device, "onnx_torch.build_fn")
    host: dict[str, Any] = dict(model.initializers)
    for node in model.nodes:
        if node.op_type == "Constant":
            host[node.outputs[0]] = node.attr("value")
    on_dev = {name: torch.from_numpy(np.array(arr)).to(dev) for name, arr in host.items()
              if np.asarray(arr).dtype.kind in "fiub"}
    # BatchNormalization over numpy statistics, folded once (onnx_jax.py:103-110)
    bn: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
    for i, node in enumerate(model.nodes):
        if node.op_type == "BatchNormalization" and all(n in host for n in node.inputs[1:5]):
            scale, bias, mean, var = (host[n] for n in node.inputs[1:5])
            eps = float(node.attr("epsilon", 1e-5))
            inv = scale / np.sqrt(np.asarray(var, np.float64) + eps).astype(np.float32)
            shift = bias - mean * inv
            bn[i] = (torch.as_tensor(inv.reshape(1, -1, 1, 1)).to(dev),
                     torch.as_tensor(shift.reshape(1, -1, 1, 1)).to(dev))

    def fn(*inputs):
        if len(inputs) != len(model.inputs):
            raise ValueError(f"expected {len(model.inputs)} inputs, got {len(inputs)}")
        env: dict[str, Any] = dict(host)
        tensors: dict[str, torch.Tensor] = dict(on_dev)
        for name, value in zip(model.inputs, inputs):
            env[name] = tensors[name] = torch.as_tensor(value).to(dev)

        def t(name: str) -> torch.Tensor:
            """The input ``name`` as a device tensor (host folds are copied)."""
            if name not in tensors:
                tensors[name] = torch.as_tensor(np.asarray(env[name])).to(dev)
            return tensors[name]

        for i, node in enumerate(model.nodes):
            names = node.inputs
            args = [env[n] if n else None for n in names]
            op = node.op_type
            if op == "Conv":
                w = t(names[1])
                group = int(node.attr("group", 1))
                strides = _pair(node.attr("strides"), 1)
                dil = _pair(node.attr("dilations"), 1)
                x = t(names[0])
                x, pad = pad_hw(x, _pads(node, x, w.shape[2:], strides, dil), conv=True)
                b = t(names[2]) if len(names) > 2 and names[2] else None
                out = F.conv2d(x, w, b, strides, pad, dil, group)
            elif op == "BatchNormalization":
                if i in bn:
                    inv, shift = bn[i]
                else:
                    scale, bias, mean, var = (t(n) for n in names[1:5])
                    eps = float(node.attr("epsilon", 1e-5))
                    inv = scale * torch.rsqrt(var + eps)
                    shift = bias - mean * inv
                    inv, shift = inv.reshape(1, -1, 1, 1), shift.reshape(1, -1, 1, 1)
                out = torch.addcmul(shift, t(names[0]), inv)
            elif op == "Relu":
                out = F.relu(t(names[0]))
            elif op == "LeakyRelu":
                out = F.leaky_relu(t(names[0]), float(node.attr("alpha", 0.01)))
            elif op == "PRelu":
                x, slope = t(names[0]), t(names[1])
                s = slope.reshape(1, -1, 1, 1) if slope.ndim in (1, 3) else slope
                out = torch.where(x >= 0, x, x * s)
            elif op == "Sigmoid":
                out = torch.sigmoid(t(names[0]))
            elif op == "Softmax":
                out = torch.softmax(t(names[0]), dim=int(node.attr("axis", -1)))
            elif op == "Exp":
                out = torch.exp(t(names[0]))
            elif op == "Clip":
                lo = t(names[1]) if len(names) > 1 and names[1] \
                    else float(node.attr("min", -np.inf))
                hi = t(names[2]) if len(names) > 2 and names[2] \
                    else float(node.attr("max", np.inf))
                out = torch.clamp(torch.clamp(t(names[0]), min=lo), max=hi)
            elif op in ("Add", "Sub", "Mul", "Div"):
                a, b = t(names[0]), t(names[1])
                out = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
                       "Div": torch.div}[op](a, b)
            elif op == "Concat":
                ax = int(node.attr("axis", 0))
                out = torch.cat([t(n) for n in names], dim=ax) \
                    if any(isinstance(a, torch.Tensor) for a in args) \
                    else np.concatenate(args, axis=ax)
            elif op == "MaxPool":
                k = _pair(node.attr("kernel_shape"), 1)
                strides = _pair(node.attr("strides"), 1)
                x = t(names[0])
                out = F.max_pool2d(pad_hw(x, _pads(node, x, k, strides), -np.inf), k, strides)
            elif op == "AveragePool":
                k = _pair(node.attr("kernel_shape"), 1)
                strides = _pair(node.attr("strides"), 1)
                x = t(names[0])
                ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=dev)
                pads = _pads(node, x, k, strides)
                total = F.avg_pool2d(pad_hw(x, pads), k, strides, divisor_override=1)
                cnt = F.avg_pool2d(pad_hw(ones, pads), k, strides, divisor_override=1)
                out = total / cnt
            elif op == "GlobalAveragePool":
                out = torch.mean(t(names[0]), dim=(2, 3), keepdim=True)
            elif op in ("Resize", "Upsample"):
                x = t(names[0])
                mode = node.attr("mode", b"nearest")
                mode = mode.decode() if isinstance(mode, bytes) else mode
                if op == "Resize":
                    # inputs: X, roi, scales, sizes (opset 11+)
                    sizes = args[3] if len(args) > 3 and args[3] is not None else None
                    scales = args[2] if len(args) > 2 and args[2] is not None else None
                else:
                    sizes, scales = None, args[1]
                if sizes is not None and np.asarray(sizes).size:
                    shape = tuple(_const_int_list(sizes))
                else:
                    sc = np.asarray(scales).reshape(-1)
                    shape = tuple(int(round(d * s)) for d, s in zip(x.shape, sc))
                out = resize(x, shape, mode)
            elif op == "Reshape":
                out = t(names[0]).reshape(tuple(_const_int_list(args[1])))
            elif op == "Flatten":
                ax = int(node.attr("axis", 1))
                x = t(names[0])
                lead = int(np.prod(x.shape[:ax])) if ax else 1
                out = x.reshape(lead, -1)
            elif op == "Transpose":
                x = t(names[0])
                perm = node.attr("perm")
                out = x.permute(tuple(perm) if perm else tuple(range(x.ndim - 1, -1, -1)))
            elif op == "Gemm":
                a, b = t(names[0]), t(names[1])
                if int(node.attr("transA", 0)):
                    a = a.T
                if int(node.attr("transB", 0)):
                    b = b.T
                out = float(node.attr("alpha", 1.0)) * (a @ b)
                if len(names) > 2 and names[2]:
                    out = out + float(node.attr("beta", 1.0)) * t(names[2])
            elif op == "MatMul":
                out = t(names[0]) @ t(names[1])
            elif op == "Shape":
                out = np.asarray(np.shape(args[0]), np.int64)
            elif op == "Gather":
                ax = int(node.attr("axis", 0))
                idx = np.asarray(args[1])
                if not isinstance(args[0], torch.Tensor):
                    out = np.take(args[0], idx, axis=ax)
                else:
                    x = args[0]
                    flat = np.where(idx < 0, idx + x.shape[ax], idx).reshape(-1)
                    out = x.index_select(ax, torch.as_tensor(flat).to(dev)).reshape(
                        tuple(x.shape[:ax]) + idx.shape + tuple(x.shape[ax + 1:]))
            elif op == "Unsqueeze":
                axes = node.attr("axes") or _const_int_list(args[1])
                x = args[0]
                for ax in sorted(axes):
                    x = x.unsqueeze(ax) if isinstance(x, torch.Tensor) else np.expand_dims(x, ax)
                out = x
            elif op == "Squeeze":
                axes = node.attr("axes") or (
                    _const_int_list(args[1]) if len(args) > 1 and args[1] is not None else None)
                x = args[0]
                if isinstance(x, torch.Tensor):
                    out = x.squeeze(tuple(axes)) if axes else x.squeeze()
                else:
                    out = np.squeeze(x, axis=tuple(axes) if axes else None)
            elif op == "Slice":
                x = args[0]
                starts = _const_int_list(args[1]) if len(args) > 1 else node.attr("starts")
                ends = _const_int_list(args[2]) if len(args) > 2 else node.attr("ends")
                axes = (_const_int_list(args[3]) if len(args) > 3 and args[3] is not None
                        else node.attr("axes") or list(range(len(starts))))
                steps = (_const_int_list(args[4]) if len(args) > 4 and args[4] is not None
                         else node.attr("steps"))
                if steps and any(st != 1 for st in steps):
                    raise NotImplementedError(f"Slice steps={steps} (only 1 supported)")
                idx = [slice(None)] * x.ndim
                for s, e, a in zip(starts, ends, axes):
                    idx[a] = slice(s, None if e >= 2**31 - 1 else e)
                out = x[tuple(idx)]
            elif op == "Identity":
                out = args[0]
                if names[0] in tensors:
                    tensors[node.outputs[0]] = tensors[names[0]]
            elif op == "Constant":
                out = node.attr("value")
            else:
                raise NotImplementedError(f"ONNX op {op} (node {node.name!r})")
            outs = out if isinstance(out, tuple) else (out,)
            for name, value in zip(node.outputs, outs):
                if name:
                    env[name] = value
                    if isinstance(value, torch.Tensor):
                        tensors[name] = value
        return [env[o] for o in model.outputs]

    return fn

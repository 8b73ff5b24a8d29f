"""SCRFD-style face detector in PyTorch (port of ``livecc_tpu/tools/scrfd.py``).

The reference's ASD pipeline detects faces with insightface's ``buffalo_sc``
SCRFD model through onnxruntime (data/production/distributed_lighter_asd/
face_detector.py:9-67): an FPN detector with strides (8, 16, 32), two
anchors per location, a sigmoid face score and a 4-vector of anchor-center
distances per anchor (decoded as ``center -+ distance * stride``), followed
by score thresholding and NMS.

  * ``ScrfdConfig`` — the JAX package's, copied.
  * ``init_scrfd_params`` / ``params_from_jax`` — the parameter tree of
    JAX's ``init_scrfd_params`` with torch tensors in OIHW (a depthwise
    HWIO ``[3, 3, 1, C]`` becomes ``[C, 1, 3, 3]``, run with ``groups=C``).
  * ``Scrfd`` — an ``nn.Module`` for JAX's ``scrfd_forward``: NCHW inside,
    every conv and the stem's max pool padded as XLA's ``"SAME"`` (for
    stride 2 on an even side: 0 before, 1 after; ``onnx_torch.pad_same``),
    the top-down FPN through ``ops/resize.py``'s nearest (JAX's
    half-pixel offsets).
  * ``anchor_centers`` / ``decode_detections`` — host numpy, copied (ceil
    grids).
  * ``make_detector`` / ``load_onnx_detector`` — the ``detect_faces(frame)
    -> (boxes, scores)`` callables ``tools/asd.py:talking_ratio`` consumes;
    the second runs an ONNX graph through ``tools/onnx_torch.py``. A call
    copies its frame (uint8) to the device once and the detector's outputs
    back in one copy; normalization ``(x - 127.5) / 128`` runs on the
    device (exact in fp32, as on the host). ``detect_faces.levels`` is
    that device part alone, ``decode_detections`` the host part.
  * ``save_npz`` / ``load_npz`` — the JAX package's leaf names and HWIO
    layout: an npz written by either package loads in the other.

Frames are ``[H, W, 3]`` uint8; the reference decodes at 160x288 (H x W).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from livecc_tpu_torch.ops.resize import resize
from livecc_tpu_torch.tools.asd import nms
from livecc_tpu_torch.tools.onnx_torch import build_fn, pad_hw, pad_same, same_pads_hw
from livecc_tpu_torch.utils.device import device_for

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ScrfdConfig:
    """Detector hyperparameters (defaults mirror buffalo_sc's contract:
    strides 8/16/32, 2 anchors, frames of 160x288 (H x W),
    face_detector.py:9-21)."""

    strides: tuple[int, ...] = (8, 16, 32)
    num_anchors: int = 2
    stem_channels: int = 16
    fpn_channels: int = 24
    head_channels: int = 32
    score_threshold: float = 0.5
    nms_threshold: float = 0.4


def _conv_init(gen, cout, cin, h, w):
    fan_in = h * w * cin
    return torch.randn((cout, cin, h, w), generator=gen) * fan_in**-0.5


def init_scrfd_params(cfg: ScrfdConfig, generator: torch.Generator) -> Params:
    """Random parameters (JAX's distribution, drawn from ``generator``) in
    the port's layout: JAX's tree with OIHW kernels."""
    c0, cf, ch = cfg.stem_channels, cfg.fpn_channels, cfg.head_channels
    g = generator
    params: Params = {
        "stem": {"kernel": _conv_init(g, c0, 3, 3, 3)},
        "stages": [],
        "lateral": [],
        "head": {
            "conv1": {"kernel": _conv_init(g, ch, cf, 3, 3)},
            "conv2": {"kernel": _conv_init(g, ch, ch, 3, 3)},
            "score": {"kernel": _conv_init(g, cfg.num_anchors, ch, 1, 1),
                      "bias": torch.full((cfg.num_anchors,), -4.0)},   # rare-positive prior
            "bbox": {"kernel": _conv_init(g, cfg.num_anchors * 4, ch, 1, 1),
                     "bias": torch.zeros((cfg.num_anchors * 4,))},
        },
    }
    cin = c0
    for i, _stride in enumerate(cfg.strides):
        cout = c0 * 2 ** (i + 1)
        params["stages"].append({
            "dw": {"kernel": _conv_init(g, cin, 1, 3, 3) * np.sqrt(cin)},
            "pw": {"kernel": _conv_init(g, cout, cin, 1, 1)},
        })
        params["lateral"].append({"kernel": _conv_init(g, cf, cout, 1, 1)})
        cin = cout
    return params


def _iter_leaves(tree, prefix=()):  # stable name/value pairs, as JAX's save_npz
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter_leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(v, fn) for v in tree]
    return fn(tree)


def _hwio_to_oihw(v: np.ndarray) -> torch.Tensor:
    v = np.asarray(v, np.float32)
    return torch.from_numpy(np.array(v.transpose(3, 2, 0, 1) if v.ndim == 4 else v))


def _oihw_to_hwio(v: torch.Tensor) -> np.ndarray:
    v = v.detach().cpu().numpy()
    return v.transpose(2, 3, 1, 0) if v.ndim == 4 else v


def params_from_jax(params) -> Params:
    """JAX's parameter tree (HWIO kernels, any array type) -> the port's
    (torch float32 tensors, OIHW kernels)."""
    return _map_leaves(params, _hwio_to_oihw)


def _conv(x, kernel, bias=None, stride=1, groups=1):
    """NCHW conv padded as XLA's ``"SAME"`` (scrfd.py:93-97)."""
    x, pad = pad_hw(x, same_pads_hw(x, kernel.shape[2:], (stride, stride)), conv=True)
    return F.conv2d(x, kernel, bias, stride, pad, 1, groups)


class Scrfd(nn.Module):
    """JAX's ``scrfd_forward`` (scrfd.py:100-133) over the port's params,
    held as buffers named by their npz leaf path (``/`` -> ``_``)."""

    def __init__(self, params: Params, cfg: ScrfdConfig):
        super().__init__()
        self.cfg = cfg
        self._names = []
        for key, value in _iter_leaves(params):
            name = "_".join(key)
            self.register_buffer(name, torch.as_tensor(value, dtype=torch.float32))
            self._names.append((key, name))

    def params(self) -> Params:
        tree: Params = {}
        for key, name in self._names:
            node = tree
            for p in key[:-1]:
                node = node.setdefault(p, {})
            node[key[-1]] = getattr(self, name)
        for k in ("stages", "lateral"):
            tree[k] = [tree[k][str(i)] for i in range(len(tree[k]))]
        return tree

    def forward(self, frames: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """uint8/float frames [B, H, W, 3] -> per level (score [B, A],
        bbox [B, A, 4]); A = ceil(H/s) * ceil(W/s) * num_anchors, bbox in
        stride units (``decode_detections`` scales them)."""
        p = self.params()
        x = (frames.to(torch.float32) - 127.5) / 128.0      # face_detector.py:64
        x = x.permute(0, 3, 1, 2)
        x = F.relu(_conv(x, p["stem"]["kernel"], stride=2))
        x = F.max_pool2d(pad_same(x, (3, 3), (2, 2), value=-np.inf), 3, 2)
        feats = []
        for stage in p["stages"]:
            x = F.relu(_conv(x, stage["dw"]["kernel"], stride=2, groups=x.shape[1]))
            x = F.relu(_conv(x, stage["pw"]["kernel"]))
            feats.append(x)
        # top-down FPN: upsample coarser level into finer laterals
        laterals = [_conv(f, lat["kernel"]) for f, lat in zip(feats, p["lateral"])]
        for i in range(len(laterals) - 2, -1, -1):
            laterals[i] = laterals[i] + resize(laterals[i + 1], laterals[i].shape, "nearest")
        head = p["head"]
        outs = []
        for lvl in laterals:
            h = F.relu(_conv(lvl, head["conv1"]["kernel"]))
            h = F.relu(_conv(h, head["conv2"]["kernel"]))
            score = _conv(h, head["score"]["kernel"], head["score"]["bias"])
            bbox = _conv(h, head["bbox"]["kernel"], head["bbox"]["bias"])
            b = score.shape[0]
            outs.append((
                torch.sigmoid(score).permute(0, 2, 3, 1).reshape(b, -1),      # [B, A]
                bbox.permute(0, 2, 3, 1).reshape(b, -1, 4),                    # [B, A, 4]
            ))
        return outs


def anchor_centers(height: int, width: int, stride: int, num_anchors: int) -> np.ndarray:
    """Flattened anchor centers for one FPN level — exactly the reference's
    construction (face_detector.py:15-20): xy grid * stride, repeated per
    anchor. Grid dims use CEIL division: the SAME-padded stride-2 conv
    chain produces ceil-sized feature maps, so for frames whose H/W is not
    a multiple of the stride the anchor count must match
    ceil(h/s)*ceil(w/s) (the reference's 160x288 input hides this)."""
    centers = np.stack(
        np.mgrid[: -(-height // stride), : -(-width // stride)][::-1], axis=-1
    ).astype(np.float32)
    centers = (centers * stride).reshape(-1, 2)
    return np.stack([centers] * num_anchors, axis=1).reshape(-1, 2)


def decode_detections(
    cfg: ScrfdConfig,
    level_outputs,                  # [(score [A], bbox [A,4])] per stride, one frame
    height: int,
    width: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Raw per-level outputs -> (boxes [N,4], scores [N]) after threshold+NMS.

    Distance decode matches face_detector.py:52-55: distances are scaled by
    the level stride; box = [center - d[:2], center + d[2:]].
    """
    all_boxes, all_scores = [], []
    for (score, bbox), stride in zip(level_outputs, cfg.strides):
        score = np.asarray(score)
        dist = np.asarray(bbox) * stride
        centers = anchor_centers(height, width, stride, cfg.num_anchors)
        boxes = np.concatenate([centers - dist[:, :2], centers + dist[:, 2:]], axis=1)
        keep = score >= cfg.score_threshold
        all_boxes.append(boxes[keep])
        all_scores.append(score[keep])
    boxes = np.concatenate(all_boxes, axis=0)
    scores = np.concatenate(all_scores, axis=0)
    if len(boxes):
        order = nms(boxes, scores, cfg.nms_threshold)
        boxes, scores = boxes[order], scores[order]
    return boxes, scores


def _to_host(levels) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per-level (score, bbox) device tensors of one frame -> numpy, in one
    device-to-host copy."""
    flat = torch.cat([t.reshape(-1) for lvl in levels for t in lvl]).cpu().numpy()
    out, at = [], 0
    for s, b in levels:
        n, m = s.numel(), b.numel()
        out.append((flat[at:at + n], flat[at + n:at + n + m].reshape(-1, 4)))
        at += n + m
    return out


def _detector(levels: Callable[[np.ndarray], list], cfg: ScrfdConfig
              ) -> Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]]:
    """``detect_faces(frame) -> (boxes, scores)``: ``levels(frame)`` (the
    forward on the device, its outputs in one copy back) then
    ``decode_detections`` on the host. ``detect_faces.levels`` is the first
    part alone, so a caller can time the device calls and the host apart."""

    def detect_faces(frame: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        h, w = frame.shape[:2]
        return decode_detections(cfg, levels(frame), h, w)

    detect_faces.levels = levels
    return detect_faces


def make_detector(params: Params, cfg: ScrfdConfig, device="cuda"
                  ) -> Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]]:
    """Returns ``detect_faces(frame [H,W,3] uint8) -> (boxes, scores)`` for
    tools/asd.py:talking_ratio, the forward on ``device`` ("cuda" raises
    without a card); decode and NMS run on the host."""
    dev = device_for(device, "scrfd.make_detector")
    model = Scrfd(params, cfg).to(dev).eval()

    @torch.inference_mode()
    def levels(frame: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
        outs = model(torch.as_tensor(np.asarray(frame)).to(dev)[None])
        return _to_host([(s[0], b[0]) for s, b in outs])

    return _detector(levels, cfg)


def load_onnx_detector(path: str, cfg: ScrfdConfig | None = None, device="cuda"
                       ) -> Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]]:
    """REAL-weight path: run an insightface SCRFD ONNX graph (buffalo_sc
    ``det_500m.onnx``) on ``device`` ("cuda" raises without a card) — no
    onnxruntime. The graph is parsed by ``tools.onnx_lite`` and executed by
    ``tools.onnx_torch``. Output contract as the reference
    (face_detector.py:40-58): outputs [score_8, score_16, score_32, bbox_8,
    bbox_16, bbox_32, (kps...)], scores flattened per anchor, bbox distances
    scaled by stride in ``decode_detections``."""
    from livecc_tpu_torch.tools.onnx_lite import load_model

    cfg = cfg or ScrfdConfig()
    dev = device_for(device, "scrfd.load_onnx_detector")
    fn = build_fn(load_model(path), dev)
    n_levels = len(cfg.strides)

    @torch.inference_mode()
    def levels(frame: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
        x = torch.as_tensor(np.asarray(frame)).to(dev)
        x = ((x.to(torch.float32) - 127.5) / 128.0).permute(2, 0, 1)[None]   # NCHW
        outs = fn(x)
        return _to_host([(outs[i], outs[i + n_levels]) for i in range(n_levels)])

    return _detector(levels, cfg)


def save_npz(path: str, params: Params) -> None:
    """The port's params as JAX's npz: leaf paths joined by ``/``, HWIO."""
    np.savez(path, **{"/".join(k): _oihw_to_hwio(v) for k, v in _iter_leaves(params)})


def load_npz(path: str, cfg: ScrfdConfig) -> Params:
    """npz (as written by either package's save_npz) -> the port's params."""
    data = np.load(path)
    template = init_scrfd_params(cfg, torch.Generator().manual_seed(0))
    out = template
    for key, _ in _iter_leaves(template):
        name = "/".join(key)
        if name not in data:
            raise KeyError(f"weights file missing {name}")
        node = out
        for p in key[:-1]:
            node = node[int(p)] if isinstance(node, list) else node[p]
        leaf = key[-1]
        idx = int(leaf) if isinstance(node, list) else leaf
        node[idx] = _hwio_to_oihw(data[name])
    return out

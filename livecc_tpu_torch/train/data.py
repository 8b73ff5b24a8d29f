"""Host collation: processed samples -> static-shape training Batch on a device.

Port of ``livecc_tpu/train/data.py`` (numpy host code; the JAX module
imports ``jax.numpy``, so the port keeps its own copy). Sequence lengths and
patch counts are padded to power-of-two buckets; ``pack_samples`` merges
samples into rows of up to ``seq_len`` tokens with int32 segment ids (1..n
per sample, 0 = pad), positions restarting per sample and each sample's
first label forced -100 so the next-token shift never crosses a boundary.

A processed sample is a dict with ``input_ids`` / ``labels`` int32 ``[1, S]``,
``position_ids`` ``[3, 1, S]``, ``pixel_patches`` ``[N, patch_dim]`` or None
and ``video_grid_thw`` ``[n_clips, 3]`` (plus optional ``image_patches`` /
``image_grid_thw``), as ``LMMDataset.__getitem__`` returns it.

One difference from JAX: a window with no video at all gets no vision
arrays (``Batch.vision_patches`` is None). JAX runs the ViT on a bucket of
zero patches whose embeddings land on no token; the port skips it.
"""

from __future__ import annotations

import warnings
from typing import Any, Sequence

import numpy as np
import torch

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.ops.rope import vision_rotary_cos_sin
from livecc_tpu_torch.train.step import Batch

SEQ_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
PATCH_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


def _n_patches(row_samples, key: str) -> int:
    return sum(x[key].shape[0] if x.get(key) is not None else 1 for x in row_samples)


def _collate_arrays(samples: list[dict[str, Any]], cfg: ModelConfig,
                    rows: int = 1) -> dict[str, Any]:
    """``collate`` as numpy arrays (the JAX Batch's fields, same values)."""
    assert len(samples) % rows == 0, (len(samples), rows)
    a = len(samples) // rows
    window = [samples[i * rows:(i + 1) * rows] for i in range(a)]
    s_max = _bucket(max(x["input_ids"].shape[1] for x in samples), SEQ_BUCKETS)
    n_max = _bucket(max(_n_patches(r, "pixel_patches") for r in window), PATCH_BUCKETS)
    # uniform spatial grid across the window -> the ViT's grouped path (K3)
    hws = {(int(g[1]), int(g[2]))
           for x in samples if x["pixel_patches"] is not None
           for g in x["video_grid_thw"]}
    vision_group = None
    if len(hws) == 1:
        (gh, gw), = hws
        vision_group = gh * gw
        n_max = -(-n_max // vision_group) * vision_group
    hd, pd = cfg.vision.head_dim, cfg.vision.patch_dim

    ids = np.zeros((a, rows, s_max), np.int32)
    labels = np.full((a, rows, s_max), -100, np.int32)
    pos = np.zeros((a, 3, rows, s_max), np.int32)
    mask = np.zeros((a, rows, s_max), bool)
    patches = np.zeros((a, n_max, pd), np.float32)
    cos = np.ones((a, n_max, hd), np.float32)
    sin = np.zeros((a, n_max, hd), np.float32)
    seg = np.full((a, n_max), -1, np.int32)
    has_images = any(x.get("image_patches") is not None for x in samples)
    ni_max = _bucket(max(_n_patches(r, "image_patches") for r in window),
                     PATCH_BUCKETS) if has_images else 0
    ipatches = np.zeros((a, ni_max, pd), np.float32)
    icos = np.ones((a, ni_max, hd), np.float32)
    isin = np.zeros((a, ni_max, hd), np.float32)
    iseg = np.full((a, ni_max), -1, np.int32)

    def append_clips(dst_p, dst_c, dst_s, dst_seg, i, off, clip_idx, p, grids):
        c, sn = vision_rotary_cos_sin(grids, hd, spatial_merge_size=cfg.vision.spatial_merge_size)
        dst_p[i, off: off + p.shape[0]] = p
        dst_c[i, off: off + c.shape[0]] = c
        dst_s[i, off: off + sn.shape[0]] = sn
        dst_seg[i, off: off + p.shape[0]] = np.concatenate(
            [np.repeat(np.arange(t) + 10**6 * (clip_idx + j), h * w)
             for j, (t, h, w) in enumerate(grids)])
        return off + p.shape[0], clip_idx + len(grids)

    for i, row_samples in enumerate(window):
        v_off = i_off = v_clip = i_clip = 0
        for b, x in enumerate(row_samples):
            n = x["input_ids"].shape[1]
            ids[i, b, :n] = x["input_ids"][0]
            labels[i, b, :n] = x["labels"][0]
            pos[i, :, b, :n] = x["position_ids"][:, 0]
            pos[i, :, b, n:] = pos[i, :, b, n - 1: n] + np.arange(1, s_max - n + 1)
            mask[i, b, :n] = True
            if has_images and x.get("image_patches") is not None:
                i_off, i_clip = append_clips(ipatches, icos, isin, iseg, i, i_off, i_clip,
                                             x["image_patches"],
                                             [tuple(g) for g in x["image_grid_thw"]])
            if x["pixel_patches"] is not None:
                v_off, v_clip = append_clips(patches, cos, sin, seg, i, v_off, v_clip,
                                             x["pixel_patches"],
                                             [tuple(g) for g in x["video_grid_thw"]])
    out = dict(input_ids=ids, labels=labels, position_ids=pos, attention_mask=mask,
               vision_patches=patches, vision_cos=cos, vision_sin=sin, vision_seg_ids=seg,
               image_patches=None, image_cos=None, image_sin=None, image_seg_ids=None,
               vision_group=vision_group, image_group=None)
    if has_images:
        out.update(image_patches=ipatches, image_cos=icos, image_sin=isin, image_seg_ids=iseg)
    return out


def _batch(arrays: dict[str, Any], samples, device) -> Batch:
    """numpy arrays -> a ``Batch`` on ``device``; a window with no video
    gets no vision arrays."""
    if not any(x.get("pixel_patches") is not None for x in samples):
        arrays = dict(arrays, vision_patches=None, vision_cos=None, vision_sin=None,
                      vision_seg_ids=None)
    return Batch(**{name: torch.from_numpy(val).to(device) if isinstance(val, np.ndarray)
                    else val for name, val in arrays.items()})


def collate(samples: list[dict[str, Any]], cfg: ModelConfig, rows: int = 1,
            device="cuda") -> Batch:
    """Stack processed samples into one accumulation-window Batch on
    ``device``: micro-step ``a`` holds ``samples[a*rows:(a+1)*rows]``."""
    return _batch(_collate_arrays(samples, cfg, rows), samples, device)


def pack_samples(samples: list[dict[str, Any]], seq_len: int, max_rows: int | None = None
                 ) -> tuple[list[dict[str, Any]], list[dict[str, Any]]]:
    """Greedily merge processed samples into packed pseudo-samples of at
    most ``seq_len`` tokens each (first-fit in arrival order, no reordering).

    Returns ``(packed, leftovers)``: ``leftovers`` are the samples in no
    returned row, in their original order. Samples longer than ``seq_len``
    are dropped with a warning; ``max_rows`` stops once that many rows are
    CLOSED."""
    packed: list[dict[str, Any]] = []
    cur: dict[str, Any] | None = None
    cur_members: list[dict[str, Any]] = []
    leftovers: list[dict[str, Any]] = []

    def close():
        nonlocal cur
        if cur is not None:
            packed.append(cur)
            cur = None
            cur_members.clear()

    for si, x in enumerate(samples):
        if max_rows is not None and len(packed) >= max_rows:
            leftovers.extend(cur_members)
            cur = None
            leftovers.extend(samples[si:])
            return packed, leftovers
        n = x["input_ids"].shape[1]
        if n > seq_len:
            warnings.warn(f"pack_samples: dropping a {n}-token sample > seq_len {seq_len}")
            continue
        if cur is not None and cur["input_ids"].shape[1] + n > seq_len:
            close()
        labels = x["labels"].copy()
        labels[0, 0] = -100
        if cur is None:
            cur = {
                "input_ids": x["input_ids"].copy(),
                "labels": labels,
                "position_ids": x["position_ids"].copy(),
                "segments": np.ones((1, n), np.int32),
                "pixel_patches": x["pixel_patches"],
                "video_grid_thw": x["video_grid_thw"],
                "image_patches": x.get("image_patches"),
                "image_grid_thw": x.get("image_grid_thw"),
                "n_samples": 1,
            }
        else:
            k = cur["n_samples"] + 1
            cur["input_ids"] = np.concatenate([cur["input_ids"], x["input_ids"]], axis=1)
            cur["labels"] = np.concatenate([cur["labels"], labels], axis=1)
            cur["position_ids"] = np.concatenate([cur["position_ids"], x["position_ids"]], axis=2)
            cur["segments"] = np.concatenate([cur["segments"], np.full((1, n), k, np.int32)],
                                             axis=1)
            for pk, gk in (("pixel_patches", "video_grid_thw"),
                           ("image_patches", "image_grid_thw")):
                if x.get(pk) is not None:
                    cur[pk] = x[pk] if cur.get(pk) is None else np.concatenate([cur[pk], x[pk]])
                    cur[gk] = x[gk] if cur.get(gk) is None else np.concatenate([cur[gk], x[gk]])
            cur["n_samples"] = k
        cur_members.append(x)
    if max_rows is None or len(packed) < max_rows:
        close()
    else:
        leftovers.extend(cur_members)
    return packed, leftovers


def collate_packed(samples: list[dict[str, Any]], cfg: ModelConfig, *, rows: int = 1,
                   seq_len: int = 8192, device="cuda") -> Batch:
    """``pack_samples`` + ``collate``; the Batch's attention_mask carries
    int32 segment ids instead of a bool validity mask (0 = pad)."""
    packed, _ = pack_samples(samples, seq_len)
    return collate_packed_rows(packed, cfg, rows=rows, device=device)


def collate_packed_rows(packed: list[dict[str, Any]], cfg: ModelConfig, *, rows: int = 1,
                        accum: int | None = None, device="cuda") -> Batch:
    """Collate ALREADY-packed rows (``pack_samples`` output); the Batch's
    attention_mask holds their segment ids. ``accum`` forces the
    accumulation depth: missing rows are padded with empty rows."""
    packed = list(packed)
    target = None if accum is None else accum * rows
    if target is not None:
        assert len(packed) <= target, (len(packed), target)
    # an empty row is all pad (segment 0, zero supervised tokens)
    while (len(packed) % rows) or (target is not None and len(packed) < target):
        packed.append({
            "input_ids": np.full((1, 1), 0, np.int32),
            "labels": np.full((1, 1), -100, np.int32),
            "position_ids": np.zeros((3, 1, 1), np.int32),
            "segments": np.zeros((1, 1), np.int32),
            "pixel_patches": None, "video_grid_thw": None,
            "image_patches": None, "image_grid_thw": None,
            "n_samples": 0,
        })
    arrays = _collate_arrays(packed, cfg, rows=rows)
    a = len(packed) // rows
    seg = np.zeros((a, rows, arrays["input_ids"].shape[-1]), np.int32)
    for i in range(a):
        for b in range(rows):
            x = packed[i * rows + b]
            seg[i, b, :x["segments"].shape[1]] = x["segments"][0]
    arrays["attention_mask"] = seg
    return _batch(arrays, packed, device)

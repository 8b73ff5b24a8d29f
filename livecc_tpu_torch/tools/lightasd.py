"""Light-ASD active-speaker scorer in PyTorch (port of
``livecc_tpu/tools/lightasd.py``), weight-compatible with the reference
checkpoint.

Reference: data/production/distributed_lighter_asd/model/{Encoder,
Classifier,Model}.py + lightasd.py — a small audio-visual net scoring
whether a tracked face tube is speaking:

- visual encoder (Encoder.py:83-117): grayscale face tubes [B,T,112,112],
  normalized (x/255 - 0.4161)/0.1688 (Model.py:18), through three
  Visual_Blocks — parallel (1,3,3)/(1,5,5) spatial convs each followed by
  a (3,1,1)/(5,1,1) temporal conv, branches summed, 1x1x1 fuse conv; every
  conv is bias-free + BatchNorm(eps=1e-3) + ReLU (Encoder.py:38-80).
  Block1 downsamples spatially 2x; (1,3,3)-stride-(1,2,2) max pools after
  blocks 1 and 2; adaptive spatial MAX pool to [B,T,128].
- audio encoder (Encoder.py:129-156): MFCC [B,4T,13] as a (freq,time)
  image through three Audio_Blocks; time max-pooled 2x after blocks 1 and
  2 (100 fps MFCC -> 25 fps features); mean over freq -> [B,T,128].
- backend (Model.py:27-30 + Classifier.py): audio + visual embeddings
  ADDED, then a sequential bi-GRU — forward GRU(128), GELU, a GRU(128) run
  over that output reversed in time, GELU — and the lossAV head
  Linear(128,2) whose class-1 logit is the per-frame speaking score.

As the JAX package: fp32 throughout; torch's symmetric conv padding; the
BatchNorms folded into per-channel ``scale`` / ``bias`` buffers applied
after each bias-free conv; GELU exact (erf). The backward GRU is NOT
``nn.GRU(bidirectional=True)``: it reads the forward GRU's GELU'd output
(JAX's two ``lax.scan`` s). Each direction is an ``nn.GRU`` (gates r|z|n,
n = tanh(W_in x + b_in + r * (W_hn h + b_hn)), JAX's step); cuDNN may serve
it on the card, as no Pallas kernel served JAX's.

The port's state dict (``LightASD().state_dict()`` keys) is the
reference's without the BatchNorm statistics: ``visualEncoder.blockN.
{s_3,t_3,s_5,t_5,last}.{weight,scale,bias}``, ``audioEncoder.blockN.
{m_3,...}``, ``GRU.gru_{forward,backward}.{weight,bias}_{ih,hh}_l0`` and
``FC.{weight,bias}``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from livecc_tpu_torch.utils.device import device_for

VISUAL_SIZE = 112        # grayscale face crop side (asd_utils resized_crop)
FEAT_DIM = 128
VISUAL_MEAN = 0.4161     # Model.py:18
VISUAL_STD = 0.1688
BN_EPS = 1e-3

_VIS_BRANCHES = ("s_3", "t_3", "s_5", "t_5", "last")
_AUD_BRANCHES = ("m_3", "t_3", "m_5", "t_5", "last")


class _ConvBN(nn.Module):
    """Bias-free conv (3D or 2D, symmetric padding) + folded BatchNorm + ReLU."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin) + tuple(kernel)))
        self.register_buffer("scale", torch.ones(cout))
        self.register_buffer("bias", torch.zeros(cout))
        self.stride, self.padding = stride, padding
        self._conv = F.conv3d if len(kernel) == 3 else F.conv2d

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = self._conv(x, self.weight, None, self.stride, self.padding)
        return F.relu(y * self.scale.view(shape) + self.bias.view(shape))


class _VisualBlock(nn.Module):
    def __init__(self, cin, cout, down: bool):
        super().__init__()
        s = (1, 2, 2) if down else (1, 1, 1)
        self.s_3 = _ConvBN(cin, cout, (1, 3, 3), s, (0, 1, 1))
        self.t_3 = _ConvBN(cout, cout, (3, 1, 1), 1, (1, 0, 0))
        self.s_5 = _ConvBN(cin, cout, (1, 5, 5), s, (0, 2, 2))
        self.t_5 = _ConvBN(cout, cout, (5, 1, 1), 1, (2, 0, 0))
        self.last = _ConvBN(cout, cout, (1, 1, 1))

    def forward(self, x):
        return self.last(self.t_3(self.s_3(x)) + self.t_5(self.s_5(x)))


class _AudioBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.m_3 = _ConvBN(cin, cout, (3, 1), 1, (1, 0))
        self.t_3 = _ConvBN(cout, cout, (1, 3), 1, (0, 1))
        self.m_5 = _ConvBN(cin, cout, (5, 1), 1, (2, 0))
        self.t_5 = _ConvBN(cout, cout, (1, 5), 1, (0, 2))
        self.last = _ConvBN(cout, cout, (1, 1))

    def forward(self, x):
        return self.last(self.t_3(self.m_3(x)) + self.t_5(self.m_5(x)))


class _Encoders(nn.Module):
    def __init__(self, visual: bool):
        super().__init__()
        f = FEAT_DIM
        if visual:
            self.block1 = _VisualBlock(1, 32, down=True)
            self.block2 = _VisualBlock(32, 64, down=False)
            self.block3 = _VisualBlock(64, f, down=False)
        else:
            self.block1 = _AudioBlock(1, 32)
            self.block2 = _AudioBlock(32, 64)
            self.block3 = _AudioBlock(64, f)


class _BiGRU(nn.Module):
    def __init__(self):
        super().__init__()
        self.gru_forward = nn.GRU(FEAT_DIM, FEAT_DIM, batch_first=True)
        self.gru_backward = nn.GRU(FEAT_DIM, FEAT_DIM, batch_first=True)

    def forward(self, x):
        x = F.gelu(self.gru_forward(x)[0], approximate="none")
        x = self.gru_backward(x.flip(1))[0].flip(1)            # lax.scan(reverse=True)
        return F.gelu(x, approximate="none")                    # Classifier.py:15-22


class LightASD(nn.Module):
    """The reference net; ``forward(faces, mfcc)`` -> per-frame speaking
    logits [B, T] (``lightasd_scores``)."""

    def __init__(self):
        super().__init__()
        self.visualEncoder = _Encoders(visual=True)
        self.audioEncoder = _Encoders(visual=False)
        self.GRU = _BiGRU()
        self.FC = nn.Linear(FEAT_DIM, 2)

    def visual_frontend(self, faces: torch.Tensor) -> torch.Tensor:
        """[B, T, 112, 112] raw grayscale (0..255) -> [B, T, 128]."""
        enc = self.visualEncoder
        x = ((faces / 255.0 - VISUAL_MEAN) / VISUAL_STD)[:, None]       # NCDHW
        x = F.max_pool3d(enc.block1(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = F.max_pool3d(enc.block2(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = enc.block3(x)
        return torch.amax(x, dim=(3, 4)).transpose(1, 2)   # AdaptiveMaxPool2d((1,1)), :95

    def audio_frontend(self, mfcc: torch.Tensor) -> torch.Tensor:
        """[B, 4T, n_mfcc] 100 fps MFCC -> [B, T, 128] 25 fps features."""
        enc = self.audioEncoder
        x = mfcc.transpose(1, 2)[:, None]              # [B, 1, freq, time]
        x = F.max_pool2d(enc.block1(x), (1, 3), (1, 2), (0, 1))
        x = F.max_pool2d(enc.block2(x), (1, 3), (1, 2), (0, 1))
        x = enc.block3(x)
        return torch.mean(x, dim=2).transpose(1, 2)    # mean over freq, :153-154

    def forward(self, faces: torch.Tensor, mfcc: torch.Tensor) -> torch.Tensor:
        v = self.visual_frontend(faces)                           # [B, T, F]
        a = self.audio_frontend(mfcc)                             # [B, T, F]
        # align: a no-op when mfcc covers exactly 4*T frames (the reference
        # pads it so, main.py:59); trims/zero-pads otherwise
        t = v.shape[1]
        a = F.pad(a[:, :t], (0, 0, 0, max(t - a.shape[1], 0)))
        x = self.GRU(a + v)                                       # Model.py:28
        return self.FC(x)[..., 1]


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def convert_torch_state(state_dict: dict) -> dict[str, torch.Tensor]:
    """The reference checkpoint's state dict (finetuning_TalkSet.model:
    ``model.visualEncoder.blockN.{s_3,...}.weight`` + ``bn_*`` statistics,
    ``model.audioEncoder.blockN.{m_3,...}``, ``model.GRU.gru_{forward,
    backward}.*_l0``, ``lossAV.FC.*``; ``lossV.*`` unused, as the
    reference loads with strict=False, lightasd.py:19) -> the port's state
    dict, each BatchNorm (eps 1e-3) folded in float32 numpy as the JAX
    package folds it (its lightasd.py:108-161)."""
    sd = state_dict
    out: dict[str, torch.Tensor] = {}
    for enc, branches in (("visualEncoder", _VIS_BRANCHES), ("audioEncoder", _AUD_BRANCHES)):
        for i in (1, 2, 3):
            src, dst = f"model.{enc}.block{i}", f"{enc}.block{i}"
            for name in branches:
                g, b, mean, var = (_np(sd[f"{src}.bn_{name}.{k}"]) for k in
                                   ("weight", "bias", "running_mean", "running_var"))
                inv = g / np.sqrt(var + BN_EPS)
                out[f"{dst}.{name}.weight"] = torch.from_numpy(_np(sd[f"{src}.{name}.weight"]))
                out[f"{dst}.{name}.scale"] = torch.from_numpy(inv)
                out[f"{dst}.{name}.bias"] = torch.from_numpy(b - mean * inv)
    for d in ("forward", "backward"):
        for k in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"):
            out[f"GRU.gru_{d}.{k}"] = torch.from_numpy(_np(sd[f"model.GRU.gru_{d}.{k}"]))
    out["FC.weight"] = torch.from_numpy(_np(sd["lossAV.FC.weight"]))
    out["FC.bias"] = torch.from_numpy(_np(sd["lossAV.FC.bias"]))
    return out


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX package's Light-ASD params (THWIO / HWIO kernels, GRU ``wi`` /
    ``wh`` as [in, 3H]) -> the port's state dict (OIDHW / OIHW, [3H, in])."""
    out: dict[str, torch.Tensor] = {}
    for enc, jenc, branches in (("visualEncoder", "visual", _VIS_BRANCHES),
                                ("audioEncoder", "audio", _AUD_BRANCHES)):
        for i in (1, 2, 3):
            for name in branches:
                p = params[jenc][f"block{i}"][name]
                k = _np(p["kernel"])
                perm = (4, 3, 0, 1, 2) if k.ndim == 5 else (3, 2, 0, 1)
                pre = f"{enc}.block{i}.{name}"
                out[f"{pre}.weight"] = torch.from_numpy(np.ascontiguousarray(k.transpose(perm)))
                out[f"{pre}.scale"] = torch.from_numpy(_np(p["scale"]).copy())
                out[f"{pre}.bias"] = torch.from_numpy(_np(p["bias"]).copy())
    for d, jd in (("forward", "gru_fw"), ("backward", "gru_bw")):
        p = params[jd]
        out[f"GRU.gru_{d}.weight_ih_l0"] = torch.from_numpy(np.ascontiguousarray(_np(p["wi"]).T))
        out[f"GRU.gru_{d}.weight_hh_l0"] = torch.from_numpy(np.ascontiguousarray(_np(p["wh"]).T))
        out[f"GRU.gru_{d}.bias_ih_l0"] = torch.from_numpy(_np(p["bi"]).copy())
        out[f"GRU.gru_{d}.bias_hh_l0"] = torch.from_numpy(_np(p["bh"]).copy())
    out["FC.weight"] = torch.from_numpy(np.ascontiguousarray(_np(params["fc"]["kernel"]).T))
    out["FC.bias"] = torch.from_numpy(_np(params["fc"]["bias"]).copy())
    return out


def init_lightasd_params(generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Random weights in the port's state-dict layout (the JAX package's
    distribution: He-normal kernels and GRU matrices, BN scale 1 and bias 0,
    zero GRU and head biases), drawn from ``generator``."""
    out: dict[str, torch.Tensor] = {}
    for name, v in LightASD().state_dict().items():
        if name.endswith("scale"):
            out[name] = torch.ones_like(v)
        elif name.endswith("bias") or "bias_" in name:
            out[name] = torch.zeros_like(v)
        else:
            fan_in = v[0].numel() if v.ndim > 2 else v.shape[1]
            out[name] = torch.randn(v.shape, generator=generator) * (2.0 / fan_in) ** 0.5
    return out


def make_lightasd(state: dict, device="cuda") -> LightASD:
    """A ``LightASD`` in eval mode on ``device`` ("cuda" raises without a
    card) holding ``state`` (the port's state dict)."""
    dev = device_for(device, "lightasd.make_lightasd")
    model = LightASD()
    model.load_state_dict(state)
    return model.to(dev).eval()


def load_torch_checkpoint(path: str, device="cuda") -> LightASD:
    """The reference .model file (torch state dict) as a ``LightASD`` on
    ``device``."""
    device_for(device, "lightasd.load_torch_checkpoint")
    return make_lightasd(convert_torch_state(
        torch.load(path, map_location="cpu", weights_only=True)), device)


@torch.inference_mode()
def lightasd_scores(model: LightASD, faces, mfcc) -> torch.Tensor:
    """Per-frame speaking logits [B, T] on the model's device (lossAV
    class-1 logit, >0 = talking). faces: [B, T, 112, 112] raw grayscale
    0..255; mfcc: [B, 4*T, n_mfcc] (100 fps features aligned to 25 fps
    frames, main.py:29-32). numpy inputs are copied to the device once."""
    dev = next(model.parameters()).device
    faces = torch.as_tensor(faces, dtype=torch.float32).to(dev)
    mfcc = torch.as_tensor(mfcc, dtype=torch.float32).to(dev)
    return model(faces, mfcc)


def track_score(model: LightASD, faces, mfcc) -> float:
    """Mean speaking probability over a tube — the ``score_track`` signature
    tools.asd.talking_ratio expects (after partial application)."""
    logits = lightasd_scores(model, torch.as_tensor(faces)[None], torch.as_tensor(mfcc)[None])
    return float(torch.sigmoid(logits).mean())

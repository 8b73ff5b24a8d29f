"""JAX's training switches in the port (CPU).

The JAX package reads ``TRAIN_ATTN`` (``ops/attention.py:36``), ``CE_LOGITS``
and ``CE_IMPL`` (``train/step.py:37,42``) once at import; the port reads
them the same way (``ops/attention.py:train_attn_switch``,
``train/step.py:ce_switches``) and raises on a value outside JAX's choices:

  * ``CE_LOGITS`` / ``CE_IMPL`` set ``_ce_route``'s CUDA defaults where
    ``TrainConfig`` leaves ``ce_logits`` / ``ce_impl`` None, as JAX applies
    them only on its kernel path; the CPU route stays ``scan`` in fp32 and
    a ``TrainConfig`` field still pins its half. Each case re-reads the
    switches under a monkeypatched environment, as an import would.
  * ``TRAIN_ATTN`` must name one of JAX's impls; both go to K4 (here its
    plain version), so either gives the same numbers, and it selects
    nothing.
  * An unknown value raises at import (a child process per switch).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from livecc_tpu_torch.ops import attention as pattn
from livecc_tpu_torch.train import step as pstep
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWITCHES = ("CE_LOGITS", "CE_IMPL", "TRAIN_ATTN")


def read_switches(monkeypatch, **env):
    """Set ``env`` (the others unset) and re-read the switches into the
    modules, as importing them under that environment would."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    logits, impl = pstep.ce_switches()
    monkeypatch.setattr(pstep, "CE_LOGITS", logits)
    monkeypatch.setattr(pstep, "CE_IMPL", impl)
    monkeypatch.setattr(pattn, "TRAIN_ATTN", pattn.train_attn_switch())


@pytest.mark.parametrize("env,cuda", [
    ({}, ("fused", torch.bfloat16)),
    ({"CE_LOGITS": "f32"}, ("fused", None)),
    ({"CE_IMPL": "scan"}, ("scan", torch.bfloat16)),
    ({"CE_LOGITS": "f32", "CE_IMPL": "scan"}, ("scan", None)),
    ({"CE_LOGITS": "bf16", "CE_IMPL": "fused"}, ("fused", torch.bfloat16)),
])
def test_ce_switches_set_the_cuda_route(monkeypatch, env, cuda):
    read_switches(monkeypatch, **env)
    tcfg = pstep.TrainConfig()
    assert pstep._ce_route(tcfg, torch.device("cuda")) == cuda
    assert pstep._ce_route(tcfg, torch.device("cpu")) == ("scan", None)
    pinned = pstep.TrainConfig(ce_impl="fused", ce_logits="bf16")
    assert pstep._ce_route(pinned, torch.device("cuda")) == ("fused", torch.bfloat16)
    half = pstep.TrainConfig(ce_logits="f32")
    assert pstep._ce_route(half, torch.device("cuda")) == (cuda[0], None)


@pytest.mark.parametrize("name,value", [("CE_LOGITS", "fp16"), ("CE_IMPL", "chunked"),
                                        ("TRAIN_ATTN", "xla"), ("CE_LOGITS", "")])
def test_an_unknown_switch_raises(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    read = pattn.train_attn_switch if name == "TRAIN_ATTN" else pstep.ce_switches
    with pytest.raises(ValueError, match=name):
        read()


def test_train_attn_is_read_and_both_impls_run_k4(monkeypatch):
    """``TRAIN_ATTN=flash`` is read; splash, flash and no impl give the
    same numbers (all are K4); an unknown impl raises."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 12, h, 8).astype(np.float32)) for h in (4, 2, 2))
    mask = torch.ones((1, 12), dtype=torch.bool)
    splash = pattn.train_flash_attention(q, k, v, mask, impl="splash")
    read_switches(monkeypatch, TRAIN_ATTN="flash")
    assert pattn.TRAIN_ATTN == "flash"
    assert torch.equal(pattn.train_flash_attention(q, k, v, mask, impl="flash"), splash)
    assert torch.equal(pattn.train_flash_attention(q, k, v, mask), splash)
    with pytest.raises(ValueError, match="unknown impl"):
        pattn.train_flash_attention(q, k, v, mask, impl="xla")


@pytest.mark.parametrize("name,value,module", [
    ("CE_IMPL", "chunked", "livecc_tpu_torch.train.step"),
    ("TRAIN_ATTN", "xla", "livecc_tpu_torch.ops.attention"),
])
def test_an_unknown_switch_fails_the_import(name, value, module):
    env = {k: v for k, v in os.environ.items() if k not in SWITCHES}
    env.update(PYTHONPATH=ROOT, **{name: value})
    run = subprocess.run([sys.executable, "-c", f"import {module}"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert f"ValueError: {name}={value!r}" in run.stderr, run.stderr[-2000:]

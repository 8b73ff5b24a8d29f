"""Package boundary of the PyTorch port: no jax, and mirrors pinned to JAX.

The port keeps its own copies of four jax-free pieces whose JAX modules
load jax (``core/config``, ``vision_rot_pos_ids``, ``get_rope_index``) or
belong to the JAX package (``data/chat``, ``data/tokenizer``); each test
below holds a copy to its original.
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from livecc_tpu.core import config as jcfg
from livecc_tpu.data import chat as jchat
from livecc_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from livecc_tpu.models.qwen2_vl.model import get_rope_index as jax_get_rope_index
from livecc_tpu.ops.rope import vision_rot_pos_ids as jax_vision_rot_pos_ids

from livecc_tpu_torch.core import config as pcfg
from livecc_tpu_torch.data import chat as pchat
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.models.qwen2_vl.model import get_rope_index
from livecc_tpu_torch.ops.rope import vision_rot_pos_ids
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "livecc_tpu_torch")


def test_import_leaves_jax_and_the_jax_package_out():
    """A fresh interpreter (this one already holds jax via conftest) imports
    every port module; neither jax nor livecc_tpu may be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import livecc_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(livecc_tpu_torch.__path__, "
        "'livecc_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'livecc_tpu'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 20 else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


SMOKE = os.path.join(ROOT, "chip_smoke.py")
LIBRARY_ATTENTION = r"scaled_dot_product_attention|torch\.compile|flash_attn"
# chip_smoke.py times one PyTorch call beside each kernel as its yardstick
# (library_ms), in these functions only; the port itself never calls one
SMOKE_YARDSTICKS = {"phase_kernels", "phase_k4", "phase_kernels_tp", "sdpa_packed", "sdpa_eval"}


def _sources(smoke: bool = True):
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    if smoke:
        yield SMOKE


@pytest.mark.parametrize("pattern", [
    r"^\s*(import jax|from jax)",           # the port never imports jax
    r"^\s*(import|from)\s+livecc_tpu\b",    # ... nor the JAX package
    LIBRARY_ATTENTION,                      # no library attention (chip_smoke: see below)
])
def test_port_sources_free_of(pattern):
    rx = re.compile(pattern, re.M)
    hits = [p for p in _sources(smoke=pattern != LIBRARY_ATTENTION) if rx.search(open(p).read())]
    assert not hits, hits


def test_smoke_calls_library_attention_only_as_a_yardstick():
    """In chip_smoke.py a library attention call appears only inside the
    functions that time yardsticks, never on a path the script drives."""
    import ast

    tree = ast.parse(open(SMOKE).read())
    rx = re.compile(LIBRARY_ATTENTION)
    allowed = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in SMOKE_YARDSTICKS:
            allowed.update(range(node.lineno, node.end_lineno + 1))
    lines = open(SMOKE).read().splitlines()
    hits = [i + 1 for i, line in enumerate(lines) if rx.search(line)]
    assert hits and set(hits) <= allowed, sorted(set(hits) - allowed)


@pytest.mark.parametrize("preset", ["tiny", "qwen2_vl_2b", "qwen2_vl_7b", "qwen2_vl_72b"])
def test_config_mirror_matches_jax(preset):
    if preset == "tiny":
        j, p = jcfg.tiny_config(), pcfg.tiny_config()
    else:
        j, p = getattr(jcfg.ModelConfig, preset)(), getattr(pcfg.ModelConfig, preset)()
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    for attr in ("head_dim", "mlp_hidden_dim", "patch_dim"):
        assert getattr(p.vision, attr) == getattr(j.vision, attr)
    for attr in ("head_dim", "num_kv_groups"):
        assert getattr(p.text, attr) == getattr(j.text, attr)


@pytest.mark.parametrize("grids", [[(1, 4, 4)], [(3, 22, 40)], [(2, 4, 6), (1, 8, 2)]])
def test_vision_rot_pos_ids_copy(grids):
    np.testing.assert_array_equal(vision_rot_pos_ids(grids), jax_vision_rot_pos_ids(grids))


def _multimodal_ids(cfg, grid, n_text_before=5, n_text_after=7):
    n_vid = grid[0] * grid[1] * grid[2] // 4
    return np.asarray(
        [10] * n_text_before + [cfg.vision_start_token_id] + [cfg.video_token_id] * n_vid
        + [cfg.vision_end_token_id] + [11] * n_text_after, np.int32)


@pytest.mark.parametrize("case", ["multimodal", "padded", "text_only", "text_only_padded"])
def test_get_rope_index_copy(case):
    jc, pc = jcfg.tiny_config(), pcfg.tiny_config()
    grid = (3, 4, 6)
    kw = {}
    if case.startswith("text_only"):
        ids = np.arange(2 * 9, dtype=np.int32).reshape(2, 9) + 10
    else:
        row = _multimodal_ids(jc, grid)
        ids = np.stack([row, row])
        kw["video_grid_thw"] = np.asarray([grid, grid])
    if case.endswith("padded"):
        mask = np.ones_like(ids)
        mask[1, -3:] = 0
        kw["attention_mask"] = mask
    pj, dj = jax_get_rope_index(jc, ids, **kw)
    pp, dp = get_rope_index(pc, ids, **kw)
    np.testing.assert_array_equal(pp, pj)
    np.testing.assert_array_equal(dp, dj)


def test_chat_copy_renders_the_same():
    content = [{"type": "text", "text": "Time=0.0-3.0s"}, {"type": "video", "video": None},
               {"type": "text", "text": "describe"}]
    conv = [{"role": "user", "content": content}]
    for add in (False, True):
        assert pchat.render_chat(conv, add_generation_prompt=add) == jchat.render_chat(
            conv, add_generation_prompt=add)
    assert pchat.system_prompt_offset() == jchat.system_prompt_offset()
    text = jchat.render_chat(conv, add_generation_prompt=True)
    assert pchat.strip_system_for_continuation(text) == jchat.strip_system_for_continuation(text)
    assert pchat.expand_vision_placeholders(text, video_grid_thw=[(3, 4, 6)]) == \
        jchat.expand_vision_placeholders(text, video_grid_thw=[(3, 4, 6)])


def test_tokenizer_copy_encodes_the_same():
    text = "<|im_start|>user\nTime=0.0-3.0s<|vision_start|><|video_pad|><|vision_end|> ...é<|im_end|>"
    for port_tok, jax_tok in ((ByteTokenizer(), JaxByteTokenizer()),
                              (ByteTokenizer.for_config(pcfg.ModelConfig()),
                               JaxByteTokenizer.for_config(jcfg.ModelConfig()))):
        ids = port_tok.encode(text)
        assert ids == jax_tok.encode(text)
        assert port_tok.decode(ids + [99999]) == jax_tok.decode(ids + [99999])
        assert port_tok.special_ids == jax_tok.special_ids

"""``python -m livecc_tpu_torch.train.cli`` on the CPU, against the JAX
package's ``livecc_tpu.train.cli``.

Frames come through the in-memory ``SeededClips`` loader of
``test_torch_dataset.py`` (the port's CLI takes it as ``video_loader``; JAX's
CLI reads its dataset's default ``VideoReader``, which the JAX run replaces
by the loader), so nothing needs the native decoder.

  * The tiny random init (no ``--pretrained``) trains, writes
    ``ckpt/<step>/state.pt`` and resumes by default: a second call with
    ``--total_steps 2`` continues from step 1 to the parameters and
    optimizer state of an uninterrupted 2-step run, bit for bit.
  * ``--mesh`` without torchrun's environment and ``--device cuda``
    without CUDA raise, ``--seq_shard`` without ``--mesh DATAxMODEL`` of
    MODEL >= 2 exits with code 2 as JAX's CLI (``--mesh`` itself:
    ``tests/test_torch_mesh.py``).
  * On a tiny HF directory (``tools/checkpoint.py`` from ``params_from_jax``
    of JAX's ``init_params(tiny_config(), PRNGKey(0))``, the fixture
    tokenizer as ``tokenizer.json``) both CLIs load bf16 and log the same
    losses within 1e-2 relative. Neither package's ``config_from_hf_json``
    reads ``im_start`` / ``im_end`` ids from ``config.json`` (a real
    checkpoint's are Qwen's, 151644 / 151645); the tiny tokenizer's are 427
    / 428, so both runs read the directory's config through a shim that
    sets them, or no token would be supervised.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.models.qwen2_vl.model import init_params as jax_init_params

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.lmm_dataset import write_seek_index
from livecc_tpu_torch.models import qwen2_vl as pm
from livecc_tpu_torch.tools.checkpoint import save_checkpoint
from livecc_tpu_torch.train import cli
from test_torch_dataset import TOKENIZER, SeededClips, stream_row, words
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FLAGS = ["--accum_steps", "2", "--log_steps", "1", "--learning_rate", "1e-3",
         "--warmup_ratio", "0", "--dataloader_num_workers", "1"]


def write_corpus(path, rows):
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    write_seek_index(str(path))
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two streaming rows and a plain video-QA row."""
    rows = [stream_row("clip_a.mp4", {"type": "text", "text": "commentate"}, words(20, 2.0),
                       video_start=2.0, video_end=10.0),
            stream_row("clip_c.mp4", {"type": "text", "text": "describe"}, words(9, pace=0.45)),
            [{"role": "user", "content": [{"type": "video", "video": "clip_b.mp4"},
                                          {"type": "text", "text": "what happens?"}]},
             {"role": "assistant", "content": [{"type": "text", "text": "a goal"}]}]]
    return write_corpus(tmp_path_factory.mktemp("cli") / "anns.jsonl", rows)


def run_cli(corpus, out, *flags, **kw):
    return cli.main(["--annotation_paths", corpus, "--output_dir", str(out), *FLAGS, *flags],
                    video_loader=SeededClips(), **kw)


def state(out, step):
    return torch.load(os.path.join(out, "ckpt", str(step), "state.pt"), weights_only=False)


def test_tiny_cli_trains_saves_and_resumes_bit_equal(tmp_path):
    """One step writes ``ckpt/1``; a second call with ``--total_steps 2``
    resumes from it and ends where an uninterrupted 2-step run ends: the
    same parameters, moments and step, bit for bit. The corpus holds one
    row: the trainer draws each window's samples from ``random.Random(seed
    + step at the start of train())``, as JAX's does, so after a resume a
    corpus of several rows is drawn in another order than without one."""
    one = write_corpus(tmp_path / "one.jsonl", [stream_row(
        "clip_c.mp4", {"type": "text", "text": "go"}, words(9, pace=0.45))])
    first = run_cli(one, tmp_path / "a", "--total_steps", "1", "--save_steps", "1",
                    "--device", "cpu")
    assert first["step"] == 1 and np.isfinite(first["loss"]) and first["retries"] == 0
    assert os.path.exists(tmp_path / "a" / "ckpt" / "1" / "state.pt")
    resumed = run_cli(one, tmp_path / "a", "--total_steps", "2", "--save_steps", "1",
                      "--device", "cpu")
    straight = run_cli(one, tmp_path / "b", "--total_steps", "2", "--save_steps", "2",
                       "--device", "cpu")
    assert resumed["step"] == straight["step"] == 2
    assert resumed["loss"] == straight["loss"]
    a, b = state(tmp_path / "a", 2), state(tmp_path / "b", 2)
    assert a["step"] == b["step"] == 2 and a["opt_state"]["count"] == 2
    for n, p in b["params"].items():
        assert torch.equal(a["params"][n], p), n
    for n in b["opt_state"]["mu"]:
        assert torch.equal(a["opt_state"]["mu"][n], b["opt_state"]["mu"][n]), n
        assert torch.equal(a["opt_state"]["nu"][n], b["opt_state"]["nu"][n]), n
    log = (tmp_path / "a" / "log.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in log] == [1, 2]


def test_tiny_cli_overwrite_starts_fresh(corpus, tmp_path):
    """``--overwrite_output_dir`` ignores the saved step; a resumed run at
    its last step returns only the retry count."""
    run_cli(corpus, tmp_path, "--total_steps", "1", "--save_steps", "1", "--device", "cpu")
    again = run_cli(corpus, tmp_path, "--total_steps", "1", "--save_steps", "1",
                    "--device", "cpu", "--overwrite_output_dir")
    assert again["step"] == 1
    assert run_cli(corpus, tmp_path, "--total_steps", "1", "--device", "cpu") == {"retries": 0}


def test_cli_records_time_each_step_save_and_restore(corpus, tmp_path):
    """``on_step`` reaches ``Trainer.train`` through ``main``; each record
    of ``log.jsonl`` carries the step's wall and load seconds, a saving
    step's record its save seconds, and the first record after a resume
    the restored step and its seconds (no ``peak_gib`` on the CPU)."""
    seen = []
    run_cli(corpus, tmp_path, "--total_steps", "2", "--save_steps", "2", "--device", "cpu",
            on_step=lambda step, batch, metrics: seen.append((step, batch.input_ids.shape[-1])))
    last = run_cli(corpus, tmp_path, "--total_steps", "3", "--save_steps", "2",
                   "--device", "cpu", on_step=lambda step, *_: seen.append((step, None)))
    assert [s for s, _ in seen] == [1, 2, 3] and all(n > 0 for _, n in seen[:2])
    log = [json.loads(x) for x in (tmp_path / "log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2, 3] and last["step"] == 3
    assert all(r["wall_s"] > 0 and r["load_s"] > 0 and "peak_gib" not in r for r in log)
    assert ["save_s" in r for r in log] == [False, True, True]
    assert [r.get("restored_step") for r in log] == [None, None, 2]
    assert log[2]["restore_s"] > 0 and "restore_s" not in log[0]


@pytest.mark.parametrize("flags,error", [
    (["--mesh", "4x2", "--device", "cpu"], RuntimeError),
    (["--seq_shard"], SystemExit),
    (["--mesh", "1x1", "--seq_shard"], SystemExit),
    (["--device", "cuda"], RuntimeError),
])
def test_cli_refuses_what_one_gpu_cannot_do(corpus, tmp_path, flags, error, monkeypatch, capsys):
    """``--mesh`` outside torchrun raises, naming torchrun; ``--seq_shard``
    without a model axis of at least 2 exits with code 2 naming MODEL >= 2,
    as JAX's CLI does (``livecc_tpu/train/cli.py:58-63``); ``--device
    cuda`` (the default) raises without CUDA."""
    if "cuda" in flags and torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(error) as raised:
        run_cli(corpus, tmp_path, "--total_steps", "1", *flags)
    if error is SystemExit:
        assert raised.value.code == 2 and "MODEL >= 2" in capsys.readouterr().err
    else:
        assert raised.match("CUDA|torchrun")
    assert not os.path.exists(tmp_path / "ckpt")


@pytest.fixture(scope="module")
def hf_tiny(tmp_path_factory):
    """JAX's tiny init as an HF checkpoint directory with the fixture
    tokenizer and its special ids in config.json."""
    from tokenizers import Tokenizer

    root = tmp_path_factory.mktemp("hf")
    tok = Tokenizer.from_file(TOKENIZER)
    ids = {n: tok.token_to_id(f"<|{n}|>") for n in
           ("vision_start", "vision_end", "video_pad", "image_pad", "im_end", "endoftext")}
    t, v = tiny_config().text, tiny_config().vision
    config = dict(vocab_size=t.vocab_size, hidden_size=t.hidden_size,
                  intermediate_size=t.intermediate_size, num_hidden_layers=t.num_hidden_layers,
                  num_attention_heads=t.num_attention_heads,
                  num_key_value_heads=t.num_key_value_heads,
                  rope_scaling={"type": "mrope", "mrope_section": list(t.mrope_section)},
                  bos_token_id=ids["endoftext"], eos_token_id=ids["im_end"],
                  vision_start_token_id=ids["vision_start"],
                  vision_end_token_id=ids["vision_end"], image_token_id=ids["image_pad"],
                  video_token_id=ids["video_pad"],
                  vision_config=dict(depth=v.depth, embed_dim=v.embed_dim,
                                     num_heads=v.num_heads, hidden_size=v.hidden_size))
    (root / "config.json").write_text(json.dumps(config))
    params = jax.tree_util.tree_map(np.asarray, jax_init_params(jax_tiny_config(),
                                                                jax.random.PRNGKey(0)))
    path = str(root / "tiny")
    save_checkpoint(pm.params_from_jax(params, tiny_config()), tiny_config(), path,
                    str(root / "config.json"))
    shutil.copy(TOKENIZER, os.path.join(path, "tokenizer.json"))
    return path


def chat_ids(monkeypatch):
    """Both packages' ``config_from_hf_json`` with the tokenizer's
    ``im_start`` / ``im_end`` ids set (see the module docstring)."""
    from livecc_tpu.models.qwen2_vl import convert as jconvert
    from livecc_tpu_torch.models.qwen2_vl import convert as pconvert

    for mod in (jconvert, pconvert):
        real = mod.config_from_hf_json
        monkeypatch.setattr(mod, "config_from_hf_json", lambda path, real=real: dataclasses.replace(
            real(path), im_start_token_id=427, im_end_token_id=428))


@pytest.fixture(scope="module")
def jax_cli_log(hf_tiny, corpus, tmp_path_factory):
    """JAX's CLI once on the tiny HF directory, frames through
    ``SeededClips``: its log records."""
    from livecc_tpu.train import cli as jcli
    from livecc_tpu.vision_io import video_reader as jvr

    out = tmp_path_factory.mktemp("jax_cli")
    with pytest.MonkeyPatch.context() as mp:
        chat_ids(mp)
        mp.setattr(jvr, "VideoReader", SeededClips())
        jcli.main(["--annotation_paths", corpus, "--output_dir", str(out), "--pretrained",
                   hf_tiny, "--total_steps", "2", "--save_steps", "100", *FLAGS])
    return [json.loads(x) for x in (out / "log.jsonl").read_text().splitlines()]


def test_cli_on_a_tiny_checkpoint_matches_jax(hf_tiny, corpus, jax_cli_log, tmp_path,
                                              monkeypatch):
    """The port's CLI (``--device cpu``) on the same directory, corpus and
    flags: each step's loss within 1e-2 relative of JAX's (both bf16), the
    same supervised-token counts, no retries."""
    chat_ids(monkeypatch)
    last = run_cli(corpus, tmp_path, "--pretrained", hf_tiny, "--total_steps", "2",
                   "--save_steps", "100", "--device", "cpu")
    log = [json.loads(x) for x in (tmp_path / "log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [r["step"] for r in jax_cli_log] == [1, 2]
    for mine, ref in zip(log, jax_cli_log):
        assert mine["tokens"] == ref["tokens"] > 0
        np.testing.assert_allclose(mine["loss"], ref["loss"], rtol=1e-2)
    assert last["retries"] == 0 and last["loss"] == log[-1]["loss"]

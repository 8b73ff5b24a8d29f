"""The port's data-production tools (``tools/production.py``,
``corpus_stats.py``, ``filters.py``, ``lmm4asd.py``, ``utils/multiproc.py``,
``reporting.py``, ``param_recipe.py``) against the JAX package's, on the CPU.

Host tools give identical outputs (files byte for byte). The scorers run the
tiny config in fp32 on the hf_tiny golden weights (the port's through
``bridge.params_from_jax``) and agree within 1e-5; both packages'
``TalkingHeadPredictor`` read frames through one in-memory ``video_loader``
(``MemVideo``), so no case needs the native decoder.
"""

import json
import os

import numpy as np
import pytest
import torch

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from livecc_tpu.models import qwen2_vl as jm
from livecc_tpu.tools import corpus_stats as jcs
from livecc_tpu.tools import filters as jfilters
from livecc_tpu.tools import lmm4asd as jlmm
from livecc_tpu.tools import production as jprod
from livecc_tpu.utils import multiproc as jmp
from livecc_tpu.utils import param_recipe as jrecipe
from livecc_tpu.utils import reporting as jreporting

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.models.qwen2_vl.bridge import params_from_jax
from livecc_tpu_torch.models.qwen2_vl.model import prepare_vision_inputs
from livecc_tpu_torch.tools import corpus_stats as cs
from livecc_tpu_torch.tools import filters, lmm4asd
from livecc_tpu_torch.tools import production as prod
from livecc_tpu_torch.utils import multiproc, param_recipe, reporting
from livecc_tpu_torch.vision_io.patchify import patchify_video
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "hf_tiny.npz")


@pytest.fixture(scope="module")
def models():
    """(JAX params, port model) on the hf_tiny weights, fp32."""
    g = np.load(GOLDEN)
    state = {k[len("state::"):]: g[k] for k in g.files if k.startswith("state::")}
    params = jm.convert_state_dict(state, jax_tiny_config())
    return params, params_from_jax(params, tiny_config())


# --- host tools -----------------------------------------------------------------

def make_words(n, wps=2.0, gap_at=(), gap=5.0, seed=0):
    rng = np.random.RandomState(seed)
    words, t = [], 0.0
    for i in range(n):
        w = f"w{i}" + ("." if rng.rand() < 0.1 else "")
        words.append((round(t, 2), round(t + 1 / wps * 0.8, 2), w))
        t += 1 / wps
        if i in gap_at:
            t += gap
    return words


SUBTITLES = [
    {"start": 0.0, "end": 2.0, "text": "hello big world"},
    {"start": 2.0, "end": 3.0, "text": "[Music] again"},
    {"start": 3.0, "duration": 1.0, "text": "again more"},
    {"start": 4.0, "end": 4.0, "text": "[Applause]"},
    {"start": 4.0, "end": 6.5, "text": "a b c d e f g"},
]


def test_production_host_tools_identical_to_jax():
    assert prod.split_subtitles_to_words(SUBTITLES) == jprod.split_subtitles_to_words(SUBTITLES)
    for words in (make_words(400, gap_at=(80, 250)), make_words(900, wps=3.5, gap_at=(300,)),
                  make_words(40)):
        for kw in ({}, {"min_duration": 10.0, "max_duration": 60.0, "gap_threshold": 2.0}):
            clips = prod.clips_for_pretrain(words, **kw)
            assert clips == jprod.clips_for_pretrain(words, **kw)
            assert [prod.words_per_second_ok(c) for c in clips] == \
                [jprod.words_per_second_ok(c) for c in clips]
            assert prod.clips_for_sft(words, **kw) == jprod.clips_for_sft(words, **kw)
    for clip in ({"start": 0, "end": 10, "words": [(i, i + 0.1, "x") for i in range(60)]},
                 {"start": 5, "end": 5, "words": []}):
        assert prod.words_per_second_ok(clip) == jprod.words_per_second_ok(clip)
    clip = prod.clips_for_pretrain(make_words(400, gap_at=(80,)))[1]
    for title in (None, "Match"):
        assert prod.to_conversation("v.mp4", clip, "q?", title=title) == \
            jprod.to_conversation("v.mp4", clip, "q?", title=title)
    for reply in ("What is shown?\nYES", "query\nNO", "only a query", ""):
        for title in (None, "T"):
            prompts = []

            def llm(p, reply=reply):
                prompts.append(p)
                return reply
            assert prod.make_prompt(llm, clip, title) == jprod.make_prompt(llm, clip, title)
            assert prompts[0] == prompts[1]
    for text in ("this is english text", "это русский текст полностью", "", "mixed текст a b"):
        assert prod.detect_language(text) == jprod.detect_language(text)
        clf = lambda t: {"en": 0.95 if t.isascii() else 0.2}
        assert prod.detect_language(text, clf) == jprod.detect_language(text, clf)


def corpus_rows():
    words = make_words(300, gap_at=(70, 200))
    clips = prod.clips_for_pretrain(words)
    rows = [prod.to_conversation(f"v{i % 2}.mp4", c, "q?", title="T") for i, c in enumerate(clips)]
    rows[0][0]["content"][1]["category"] = "sports"
    return rows + [{"plain": "row"}]


def test_write_corpus_and_stats_identical_to_jax(tmp_path):
    rows = corpus_rows()
    got, want = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    prod.write_corpus(rows, got)
    jprod.write_corpus(rows, want)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    assert list(cs.iter_rows(got)) == list(jcs.iter_rows(got)) == rows
    for key in ("category", "title"):
        assert cs.corpus_stats(got, key) == jcs.corpus_stats(got, key)
    keep = lambda row: isinstance(row, list) and row[0]["content"][0]["video"] == "v0.mp4"
    fp, fj = str(tmp_path / "fp.jsonl"), str(tmp_path / "fj.jsonl")
    assert cs.filter_corpus(got, fp, keep) == jcs.filter_corpus(got, fj, keep) > 0
    with open(fp, "rb") as a, open(fj, "rb") as b:
        assert a.read() == b.read()


def test_multiproc_and_reporting_identical_to_jax(tmp_path, capsys):
    items = list(range(7))
    assert multiproc.local_mt(items, abs, num_workers=3) == jmp.local_mt(items, abs,
                                                                         num_workers=3)

    def report(n):
        print(f"rows: {n}")
        return n * 2

    assert reporting.save_function_print(report, str(tmp_path / "p.txt"), 3) == \
        jreporting.save_function_print(report, str(tmp_path / "j.txt"), 3) == 6
    with open(tmp_path / "p.txt") as a, open(tmp_path / "j.txt") as b:
        assert a.read() == b.read() == "rows: 3\n"
    assert capsys.readouterr().out == "rows: 3\nrows: 3\n"


@pytest.mark.parametrize("name, shape", [
    ("model.embed_tokens.weight", (64, 48)),
    ("model.layers.0.input_layernorm.weight", (3584,)),
    ("visual.blocks.3.attn.qkv.bias", (3840,)),
    ("model.layers.2.self_attn.q_proj.weight", (96, 3584)),
    ("lm_head.weight", (1_048_600,)),            # wraps around the pool
])
def test_param_recipe_bit_equal_to_jax(name, shape):
    got = param_recipe.recipe_tensor(name, shape)
    want = jrecipe.recipe_tensor(name, shape)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert param_recipe.RECIPE_VERSION == jrecipe.RECIPE_VERSION
    for a, b in ((param_recipe.MIDSIZE_TEXT, jrecipe.MIDSIZE_TEXT),
                 (param_recipe.MIDSIZE_VISION, jrecipe.MIDSIZE_VISION),
                 (param_recipe.MIDSIZE_TOKEN_IDS, jrecipe.MIDSIZE_TOKEN_IDS)):
        assert a == b
    ours, theirs = param_recipe.make_midsize_inputs(3), jrecipe.make_midsize_inputs(3)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


# --- scorers --------------------------------------------------------------------

SAMPLES = [
    {"title": "t", "transcript": "hello world this is a test"},
    {"previous": "earlier words", "transcript": "more words follow here"},
    {"title": "long", "transcript": " ".join(f"word{i}" for i in range(40))},
]


@pytest.mark.parametrize("max_len", [2048, 100], ids=["whole", "truncated"])
def test_lm_loss_scores_match_jax(models, max_len):
    params, model = models
    got = filters.lm_loss_scores(model, tiny_config(), ByteTokenizer(), SAMPLES,
                                 max_len=max_len)
    want = jfilters.lm_loss_scores(params, jax_tiny_config(), JaxByteTokenizer(), SAMPLES,
                                   max_len=max_len)
    assert got.shape == (3,) and np.isfinite(got).all() and (got[:2] > 0).all()
    # cut before its <|im_end|>, the long sample has no labelled span: 0 in both
    assert (got[2] > 0) == (max_len == 2048)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    scores = np.asarray([1.0, 1.5, 3.0, 5.0, 7.0])
    np.testing.assert_array_equal(filters.lm_loss_keep(scores), jfilters.lm_loss_keep(scores))


def test_talking_head_prob_matches_jax(models):
    params, model = models
    frames = np.random.RandomState(4).randint(0, 256, (4, 3, 56, 56), dtype=np.uint8)
    patches, grid = patchify_video(frames)
    got = filters.talking_head_prob(
        model, tiny_config(), ByteTokenizer(),
        prepare_vision_inputs(tiny_config(), patches, [grid], torch.device("cpu")), grid)
    want = jfilters.talking_head_prob(
        params, jax_tiny_config(), JaxByteTokenizer(),
        jm.prepare_vision_inputs(jax_tiny_config(), patches, [grid]), grid)
    assert 0.0 < got < 1.0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


class MemVideo:
    """``VideoReader``'s API over frames in memory, a nearest resize to the
    asked size; a path named ``missing*`` raises as an unreadable clip."""

    def __init__(self, path):
        name = os.path.basename(path)
        if name.startswith("missing"):
            raise IOError(f"cannot open video: {path}")
        seed = int(name[1:-4])
        self.frames = np.random.RandomState(seed).randint(0, 256, (12 + seed, 40, 64, 3),
                                                          dtype=np.uint8)

    def __len__(self):
        return len(self.frames)

    def get_batch(self, indices, out_hw=None):
        out = self.frames[np.asarray(indices)]
        (h, w), (rh, rw) = self.frames.shape[1:3], out_hw
        return out[:, np.arange(rh) * h // rh][:, :, np.arange(rw) * w // rw]


VIDEOS = [f"v{i}.mp4" for i in range(4)] + ["missing.mp4", "v4.mp4"]


@pytest.fixture(scope="module")
def predictors(models):
    params, model = models
    kw = dict(num_frames=4, frame_hw=(28, 28), batch_size=3, video_loader=MemVideo)
    return (jlmm.TalkingHeadPredictor(params, jax_tiny_config(), JaxByteTokenizer(), **kw),
            lmm4asd.TalkingHeadPredictor(model, tiny_config(), ByteTokenizer(), **kw))


def test_predict_probs_match_jax(predictors):
    """Batches of 3 with a short last one, an unreadable clip (-1.0 in both),
    and batched equal to one clip at a time."""
    jp, pp = predictors
    got, want = pp.predict_probs(VIDEOS), jp.predict_probs(VIDEOS)
    assert got.dtype == np.float64 and got[4] == want[4] == -1.0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert len(set(got.tolist())) == len(VIDEOS)          # the frames reach the model
    one_by_one = np.array([pp.predict_probs([v])[0] for v in VIDEOS[:4]])
    np.testing.assert_allclose(got[:4], one_by_one, atol=2e-5)
    enc_p, enc_j = pp.encode(pp._read("v1.mp4")), jp.encode(jp._read("v1.mp4"))
    for key in ("ids", "pos", "patches"):
        np.testing.assert_array_equal(enc_p[key], enc_j[key])
    assert enc_p["grids"] == enc_j["grids"]


def test_run_lmm4asd_idempotent_and_merge_match_jax(predictors, tmp_path):
    jp, pp = predictors
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    for node in (0, 1):
        files = lmm4asd.run_lmm4asd(VIDEOS, out_p, pp, node=node, num_nodes=2, chunk_size=2)
        jfiles = jlmm.run_lmm4asd(VIDEOS, out_j, jp, node=node, num_nodes=2, chunk_size=2)
        assert [os.path.basename(f) for f in files] == [os.path.basename(f) for f in jfiles]
    merged, jmerged = lmm4asd.merge_lmm4asd(out_p), jlmm.merge_lmm4asd(out_j)
    assert sorted(merged) == sorted(jmerged) == list(range(len(VIDEOS)))
    np.testing.assert_allclose([merged[i] for i in sorted(merged)],
                               [jmerged[i] for i in sorted(jmerged)], atol=1e-5, rtol=1e-5)
    mtimes = {f: os.path.getmtime(os.path.join(out_p, f)) for f in os.listdir(out_p)}
    calls = []
    real = pp.predict_probs
    pp.predict_probs = lambda videos: calls.append(videos) or real(videos)
    try:
        again = lmm4asd.run_lmm4asd(VIDEOS, out_p, pp, node=0, num_nodes=2, chunk_size=2)
    finally:
        del pp.predict_probs
    assert not calls and [os.path.basename(f) for f in again] == sorted(
        f for f in mtimes if "node0" in f)
    assert mtimes == {f: os.path.getmtime(os.path.join(out_p, f)) for f in os.listdir(out_p)}
    part_p, part_j = str(tmp_path / "part_p"), str(tmp_path / "part_j")
    lmm4asd.run_lmm4asd(VIDEOS, part_p, pp, part=3, num_parts=4, chunk_size=10)
    jlmm.run_lmm4asd(VIDEOS, part_j, jp, part=3, num_parts=4, chunk_size=10)
    assert sorted(lmm4asd.merge_lmm4asd(part_p)) == sorted(jlmm.merge_lmm4asd(part_j)) == [3]
    with open(os.path.join(part_p, os.listdir(part_p)[0])) as f:
        assert json.load(f)[0][0] == 3
    assert lmm4asd.QUESTION == jlmm.QUESTION

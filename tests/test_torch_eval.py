"""The port's benchmark harnesses (``livecc_tpu_torch/eval``) against JAX's, on the CPU.

Both packages' ``MCQPredictor`` read frames through one in-memory
``video_loader`` (``MemVideo``: ``VideoReader``'s API, a nearest resize, a
log of the indices asked for), so no case needs the native decoder. The
model is the tiny config in fp32 on the hf_tiny golden weights (the port's
through ``bridge.params_from_jax``), with a visual budget whose least frame
is 56 x 56 so that 4 frames of 56 x 56 stay at that size.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livecc_tpu.core.config import ModelConfig as JaxModelConfig
from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from livecc_tpu.eval import captions as jcaptions
from livecc_tpu.eval import livesports3kcc as jcc
from livecc_tpu.eval import livesports3kqa as jqa
from livecc_tpu.eval import mcq as jmcq
from livecc_tpu.eval import mvbench as jmv
from livecc_tpu.eval import ovobench as jovo
from livecc_tpu.eval import subtitles as jsubs
from livecc_tpu.eval import videomme as jvm
from livecc_tpu.models import qwen2_vl as jm
from livecc_tpu.models.qwen2_vl.text import lm_logits as jax_lm_logits
from livecc_tpu.utils import flops as jflops
from livecc_tpu.vision_io.budget import VisionBudget as JaxVisionBudget

from livecc_tpu_torch.core.config import ModelConfig, tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.eval import captions, livesports3kcc, livesports3kqa, mcq, mvbench
from livecc_tpu_torch.eval import ovobench, subtitles, videomme
from livecc_tpu_torch.models.qwen2_vl.bridge import params_from_jax
from livecc_tpu_torch.models.qwen2_vl.model import prepare_vision_inputs
from livecc_tpu_torch.tools import kernel_check
from livecc_tpu_torch.utils import flops
from livecc_tpu_torch.vision_io.budget import VisionBudget
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "goldens", "hf_tiny.npz")
TOKENIZER = os.path.join(HERE, "fixtures", "tiny_tokenizer.json")
OPTIONS = ["A. x", "B. y", "C. z", "D. w"]
MIN_PIXELS = 56 * 56      # the budget's least frame: 4 frames of 56 x 56 keep their size


class MemVideo:
    """``VideoReader``'s API over frames in memory: frame i at ``i / fps``
    s, resized to ``out_hw`` by nearest rows and columns. ``asked`` logs
    every (indices, out_hw) served."""

    def __init__(self, frames: np.ndarray, fps: float, asked: list):
        self.frames, self.avg_fps, self.asked = frames, float(fps), asked
        self.frame_size = tuple(frames.shape[1:3])
        self.pts_seconds = np.arange(len(frames)) / self.avg_fps

    def __len__(self):
        return len(self.frames)

    def get_batch(self, indices, out_hw=None):
        idx = np.asarray(indices)
        self.asked.append((idx.tolist(), out_hw))
        out = self.frames[idx]
        if out_hw is not None and tuple(out_hw) != self.frame_size:
            (h, w), (rh, rw) = self.frame_size, out_hw
            out = out[:, np.arange(rh) * h // rh][:, :, np.arange(rw) * w // rw]
        return out


def synth(n, h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, size=(n, h, w, 3), dtype=np.uint8)


# path -> (frames, fps)
CLIPS = {
    "v0.mp4": (synth(8, 56, 56, 0), 4.0),
    "v1.mp4": (synth(8, 56, 56, 1), 4.0),
    "wide.mp4": (synth(8, 56, 84, 2), 4.0),
    "one_frame.mp4": (synth(1, 56, 56, 3), 10.0),
    "subfps.mp4": (synth(6, 56, 56, 4), 1.0),
    "long.mp4": (synth(40, 56, 56, 5), 10.0),
}


def loader(asked):
    return lambda path: MemVideo(*CLIPS[os.path.basename(path)], asked)


def golden_state():
    g = np.load(GOLDEN)
    return {k[len("state::"):]: g[k] for k in g.files if k.startswith("state::")}


@pytest.fixture(scope="module")
def models():
    """(JAX params, port model) on the hf_tiny weights, fp32."""
    params = jm.convert_state_dict(golden_state(), jax_tiny_config())
    return params, params_from_jax(params, tiny_config())


def predictors(models, asked_jax=None, asked_port=None, **kw):
    params, model = models
    jp = jmcq.MCQPredictor(params, jax_tiny_config(), JaxByteTokenizer(), max_frames=4,
                           budget=JaxVisionBudget(video_min_pixels=MIN_PIXELS),
                           video_loader=loader([] if asked_jax is None else asked_jax), **kw)
    pp = mcq.MCQPredictor(model, tiny_config(), ByteTokenizer(), max_frames=4,
                          budget=VisionBudget(video_min_pixels=MIN_PIXELS),
                          video_loader=loader([] if asked_port is None else asked_port), **kw)
    return jp, pp


def items(videos=("v0.mp4", "v1.mp4"), **kw):
    return [mcq.MCQItem(video=v, question=f"What happens in clip {i}?", options=OPTIONS, **kw)
            for i, v in enumerate(videos)]


def jax_items(port_items):
    return [jmcq.MCQItem(**vars(x)) for x in port_items]


# --- model and FLOP helpers ----------------------------------------------------

@pytest.mark.parametrize("grids", [[(2, 4, 4)], [(2, 4, 4), (1, 4, 4)], [(2, 4, 4), (1, 4, 6)]],
                         ids=["one clip", "two clips of one grid", "two grids"])
def test_prepare_vision_inputs_matches_jax(grids):
    n = sum(t * h * w for t, h, w in grids)
    patches = np.random.RandomState(0).randn(n, tiny_config().vision.patch_dim).astype(np.float32)
    got = prepare_vision_inputs(tiny_config(), patches, grids, torch.device("cpu"))
    want = jm.prepare_vision_inputs(jax_tiny_config(), patches, grids)
    assert got.group == want.group == (16 if len({g[1:] for g in grids}) == 1 else None)
    for name in ("patches", "cos", "sin", "seg_ids"):
        a, b = getattr(got, name), np.array(getattr(want, name))
        assert a.device.type == "cpu" and a.dtype == torch.from_numpy(b).dtype
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("preset", ["tiny", "qwen2_vl_7b"])
def test_serving_chunk_flops_matches_jax(preset):
    cfg = tiny_config() if preset == "tiny" else ModelConfig.qwen2_vl_7b()
    jcfg = jax_tiny_config() if preset == "tiny" else JaxModelConfig.qwen2_vl_7b()
    for args in ((750, 0, 16, 6160, 880), (256, 1500, 16, 1760, 880), (256, 1500, 0), (9, 4000, 3)):
        assert flops.serving_chunk_flops(cfg, *args) == jflops.serving_chunk_flops(jcfg, *args)
    assert flops.vit_forward_flops(cfg.vision, 92160, 2880) == \
        jflops.vit_forward_flops(jcfg.vision, 92160, 2880)


# --- host pieces -------------------------------------------------------------

def test_mcq_text_letter_ids_buckets_and_shards_match_jax():
    from tokenizers import Tokenizer  # noqa: F401 (HFTokenizer needs it)

    from livecc_tpu.data.tokenizer import HFTokenizer as JaxHFTokenizer

    from livecc_tpu_torch.data.tokenizer import HFTokenizer

    for kw in ({}, {"subtitles": "line one\nline two"}):
        item = items(**kw)[0]
        for prefix in ("Answer:", ovobench.ANSWER_PREFIX):
            assert mcq.build_mcq_text(item, prefix) == jmcq.build_mcq_text(jax_items([item])[0],
                                                                           prefix)
    for letters in (videomme.LETTERS, mvbench.LETTERS, ovobench.OPTIONS):
        assert mcq.letter_token_ids(ByteTokenizer(), letters) == \
            jmcq.letter_token_ids(JaxByteTokenizer(), letters)
        assert mcq.letter_token_ids(HFTokenizer(TOKENIZER), letters) == \
            jmcq.letter_token_ids(JaxHFTokenizer(TOKENIZER), letters)
    for n in (1, 512, 513, 4096, 23300, 32768):
        assert mcq._bucket(n) == jmcq._bucket(n)
    with pytest.raises(ValueError):
        mcq._bucket(32769)
    assert mcq.SEQ_BUCKETS == jmcq.SEQ_BUCKETS
    for n, w, nw in ((10, 0, 3), (10, 2, 3), (2, 1, 4)):
        assert mcq.shard_indices(n, w, nw) == jmcq.shard_indices(n, w, nw)


# --- scoring -----------------------------------------------------------------

def jax_letter_logits(jp, group, letters):
    """JAX's ``_predict_group`` up to the argmax (``livecc_tpu/eval/mcq.py``
    :213-238 and ``mcq_logits_at_last`` :76-94): fp32 [B, L]."""
    b = len(group)
    s = jmcq._bucket(max(g["ids"].shape[1] for g in group))
    ids = np.zeros((b, s), np.int32)
    pos = np.zeros((3, b, s), np.int32)
    mask = np.zeros((b, s), bool)
    last = np.zeros((b,), np.int32)
    for i, g in enumerate(group):
        n = g["ids"].shape[1]
        ids[i, :n] = g["ids"][0]
        pos[:, i, :n] = g["pos"][:, 0]
        pos[:, i, n:] = pos[:, i, n - 1:n] + np.arange(1, s - n + 1)
        mask[i, :n] = True
        last[i] = n - 1
    vision = jm.prepare_vision_inputs(jp.cfg, np.concatenate([g["patches"] for g in group]),
                                      [g["grid"] for g in group])
    logits = _jax_last_logits(jp.params, jp.cfg, jnp.asarray(ids), jnp.asarray(pos),
                              jnp.asarray(mask), jnp.asarray(last), vision)
    return np.array(logits[:, jnp.asarray(jmcq.letter_token_ids(jp.tokenizer, letters))])


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_last_logits(params, cfg, ids, pos, mask, last, vision):
    """JAX's ``mcq_logits_at_last`` before its argmax: fp32 [B, V]."""
    hidden, _ = jm.forward(params, cfg, ids, pos, vision=vision, attention_mask=mask,
                           compute_logits=False)
    last_hidden = hidden[jnp.arange(ids.shape[0]), last]
    return jax_lm_logits(params["text"], cfg.text, last_hidden[:, None, :])[:, 0]


@pytest.mark.parametrize("videos", [("v0.mp4",), ("v0.mp4", "v1.mp4"), ("v0.mp4", "wide.mp4")],
                         ids=["batch 1", "batch 2", "batch 2 two grids"])
def test_letter_logits_match_jax(models, videos):
    """The port's [B, 4] letter logits within the fp32 limit of JAX's
    forward and LM head at each row's last real token; the encoded items
    (ids, positions, patches, grid) equal JAX's."""
    jp, pp = predictors(models)
    its = items(videos)
    group = [pp.encode_item(x) for x in its]
    jgroup = [jp.encode_item(x) for x in jax_items(its)]
    for g, j in zip(group, jgroup):
        assert g["grid"] == j["grid"]
        for key in ("ids", "pos", "patches"):
            np.testing.assert_array_equal(g[key], j[key])
    got = pp.letter_logits(group, videomme.LETTERS)
    want = jax_letter_logits(jp, jgroup, videomme.LETTERS)
    assert got.shape == (len(videos), 4) and got.dtype == torch.float32
    assert kernel_check.close(got, torch.from_numpy(want), torch.float32) <= 1.0
    assert got.argmax(-1).tolist() == want.argmax(-1).tolist()


def test_letters_match_jax_and_batching(models):
    """``predict`` gives JAX's letters at batch 1 and 2 (JAX's own
    ``predict``), and the port's batched letters equal its single ones."""
    jp, pp = predictors(models)
    its = items(("v0.mp4", "v1.mp4", "wide.mp4"))
    single = pp.predict(its, batch_size=1)
    assert single == jp.predict(jax_items(its), batch_size=1)
    assert pp.predict(its, batch_size=2) == single
    assert jp.predict(jax_items(its), batch_size=2) == single


@pytest.mark.parametrize("video,start,end", [
    ("long.mp4", 1.0, 2.5),          # a window inside the clip
    ("long.mp4", 3.2, 3.3),          # shorter than 1 s: widened to [lo, lo + 1]
    ("long.mp4", -5.0, 99.0),        # clamped into the PTS range
    ("long.mp4", 3.9, None),         # open end
    ("one_frame.mp4", None, None),   # a 1-frame clip: the count inflated to 2
    ("subfps.mp4", None, None),      # 1 fps < the budget's 2: the count inflated
    ("subfps.mp4", 2.2, 2.4),        # a window between sparse PTS samples
])
def test_degenerate_windows_pick_jax_frames(models, video, start, end):
    asked_j, asked_p = [], []
    jp, pp = predictors(models, asked_j, asked_p)
    item = mcq.MCQItem(video=video, question="q", options=OPTIONS, video_start=start,
                       video_end=end)
    frames = pp._read_video(item)
    np.testing.assert_array_equal(frames, jp._read_video(jax_items([item])[0]))
    assert asked_p == asked_j and len(asked_p) == 1


def test_frame_dir_reads_jax_frames(models, tmp_path):
    from PIL import Image

    for i, frame in enumerate(synth(5, 60, 90, 6)):
        Image.fromarray(frame).save(tmp_path / f"{i:03d}.png")
    (tmp_path / "notes.txt").write_text("not a frame")
    jp, pp = predictors(models)
    item = mcq.MCQItem(video=str(tmp_path), question="q", options=OPTIONS)
    frames = pp._read_video(item)
    assert frames.shape[0] == 4 and frames.dtype == np.uint8
    np.testing.assert_array_equal(frames, jp._read_video(jax_items([item])[0]))


# --- harnesses -----------------------------------------------------------------

class FixedPredictor:
    """A predictor whose letter depends only on the item: both packages'
    harnesses get the same predictions."""

    answer_prefix = "Answer:"

    def predict(self, its, letters=("A", "B", "C", "D"), batch_size=1):
        return [letters[sum(map(ord, x.question)) % len(letters)] for x in its]


VIDEOMME_ROWS = [
    {"video": "v0.mp4", "question": f"q{i}", "options": ["A. a", "B. b", "C. c", "D. d"],
     "answer": "ABCD"[i % 4], "duration": ["short", "medium", "long"][i % 3],
     "domain": ["Sports Competition", "Knowledge"][i % 2],
     "sub_category": ["Basketball", "Astronomy", "Football"][i % 3],
     "task_type": ["Action Recognition", "OCR Problems"][i % 2],
     "video_id": f"vid{i // 2}", "question_id": str(i), "subtitles": "hello"}
    for i in range(7)
]
MVBENCH_ROWS = [
    {"video": "v0.mp4", "question": f"which {i}?", "candidates": ["cat", "dog", "fox", "owl"][:2 + i % 3],
     "answer": ["cat", "dog", "fox"][i % 3] if i != 4 else "yak", "task_type": ["Action", "Object"][i % 2]}
    for i in range(6)
]
OVOBENCH_ROWS = [
    {"task": "REC", "video": "v.mp4", "test_info": [
        {"question": "count?", "answer": 3, "realtime": 5.0},
        {"question": "count again?", "answer": "4", "realtime": 8.0}]},
    {"task": "STU", "video": "v.mp4", "question": "now?", "answer": "Yes", "realtime": 2.0},
    {"task": "EPM", "video": "v.mp4", "question": "before?", "answer": "B", "realtime": 4.0,
     "options": ["A. x", "B. y"]},
    {"task": "OCR", "video": "v.mp4", "question": "text?", "answer": "No", "realtime": 1.0},
]
LS3KQA_ROWS = [
    {"video": "v0.mp4", "question": f"who {i}?", "options": ["A. a", "B. b", "C. c", "D. d"],
     "answer": "ABCD"[i % 4], "q_type": ["who", "what"][i % 2], "ocr": i % 3 == 0,
     "begin": float(i), "end": float(i + 2)}
    for i in range(5)
]
HARNESSES = {
    "videomme": (videomme, jvm, VIDEOMME_ROWS),
    "mvbench": (mvbench, jmv, MVBENCH_ROWS),
    "ovobench": (ovobench, jovo, OVOBENCH_ROWS),
    "livesports3kqa": (livesports3kqa, jqa, LS3KQA_ROWS),
}


def write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(path)


def run_harness(mod, bench, out, kw):
    """Two workers, stride-sharded: worker 0 finds worker 1's shard missing,
    worker 1 merges."""
    assert mod.run(FixedPredictor(), bench, out, worker=0, num_workers=2, **kw) is None
    return mod.run(FixedPredictor(), bench, out, worker=1, num_workers=2, **kw)


@pytest.mark.parametrize("name", list(HARNESSES))
def test_harness_run_writes_jax_files(name, tmp_path):
    port, ref, rows = HARNESSES[name]
    bench = write_jsonl(tmp_path / "bench.jsonl", rows)
    kws = [{"with_subtitles": True}, {}] if name == "videomme" else [{}]
    for kw in kws:
        tag = "sub" if kw else "plain"
        got = run_harness(port, bench, str(tmp_path / f"port_{tag}"), kw)
        want = run_harness(ref, bench, str(tmp_path / f"jax_{tag}"), kw)
        assert got == want and got is not None
        files = sorted(os.listdir(tmp_path / f"jax_{tag}"))
        assert sorted(os.listdir(tmp_path / f"port_{tag}")) == files and len(files) >= 3
        for f in files:
            assert (tmp_path / f"port_{tag}" / f).read_bytes() == \
                (tmp_path / f"jax_{tag}" / f).read_bytes(), f


def test_scorers_match_jax():
    """``score`` of each harness on the same items and predictions (letters,
    free text, misses), the letter extractors, ``group_results`` and
    ``official_report`` of VideoMME."""
    responses = ["A", "(B)", "C.", "The answer is: D", "Answer: A because", "I think B is right",
                 "", "The best answer is C", "none of these options apply to the clip at all here",
                 "E", "d"]
    for r in responses:
        assert videomme.extract_letter(r) == jvm.extract_letter(r)
        assert videomme.extract_official(r) == jvm.extract_official(r)
    vm_items = [videomme.MCQItem(video="v", question=f"q{i}", options=["A. a", "B. b", "C. c"],
                                 answer="ABC"[i % 3], meta={k: r.get(k) for k in (
                                     "video_id", "duration", "domain", "sub_category",
                                     "task_type", "question_id")})
                for i, r in enumerate(VIDEOMME_ROWS)]
    preds = [responses[i % len(responses)] for i in range(len(vm_items))]
    jitems = jax_items(vm_items)
    assert videomme.score(vm_items, preds) == jvm.score(jitems, preds)
    letters = [videomme.extract_letter(p) or "A" for p in preds]
    grouped = videomme.group_results(vm_items, letters)
    assert grouped == jvm.group_results(jitems, letters)
    for vts in (("short", "medium", "long"), ("short",)):
        assert videomme.official_report(grouped, vts) == jvm.official_report(grouped, vts)
    with pytest.raises(ValueError):
        videomme.official_report(grouped, expected_per_type=5)
    for port, ref, rows in (HARNESSES["mvbench"], HARNESSES["livesports3kqa"]):
        its = []
        for i, row in enumerate(rows):
            meta = ({"task_type": row["task_type"]} if port is mvbench
                    else {"q_type": row["q_type"], "ocr": row["ocr"]})
            its.append(mcq.MCQItem(video="v", question="q", options=[], answer="ABCD"[i % 4],
                                   meta=meta))
        preds = ["ABCDE"[i % 5] for i in range(len(its))]
        assert port.score(its, preds) == ref.score(jax_items(its), preds)
    flat = ovobench.flatten_annotations(OVOBENCH_ROWS)
    assert flat == jovo.flatten_annotations(OVOBENCH_ROWS)
    ovo_items = [mcq.MCQItem(video="v", question="q", options=[], answer=r["answer"],
                             meta={"task": r["task"]}) for r in flat]
    preds = ["3", "0", "Yes", "B", "Yes"]
    assert ovobench.score(ovo_items, preds) == jovo.score(jax_items(ovo_items), preds)


def test_win_rate_and_judge_match_jax():
    rng = np.random.RandomState(3)
    records = [{"ab_winner": ["ours", "base", "tie"][rng.randint(3)],
                "ba_winner": ["ours", "base"][rng.randint(2)]} for _ in range(9)]
    assert livesports3kcc.win_rate_log_line(records, "ours", "base") == \
        jcc.win_rate_log_line(records, "ours", "base")
    assert livesports3kcc.tally_win_rate([], "ours") == jcc.tally_win_rate([], "ours") == 0.0

    def llm(prompt):          # prefers the commentary that mentions "goal"
        a = prompt.split("Commentary A:")[1].split("Commentary B:")[0]
        return "A" if "goal" in a else "B"

    ours = {"e1": "a goal!", "e2": "nothing", "e3": "goal again"}
    base = {"e1": "a pass", "e2": "a goal", "e4": "x"}
    truth = {"e1": "goal", "e2": "goal", "e3": "goal"}
    assert livesports3kcc.win_rate(llm, ours, base, truth) == jcc.win_rate(llm, ours, base, truth)
    assert livesports3kcc.judge_pair(llm, "g", "goal", "pass") == jcc.judge_pair(llm, "g", "goal",
                                                                                "pass") == 2
    for title, asr, instruct in (("Final", "he shoots", True), (None, None, True),
                                 ("Final", None, False)):
        assert livesports3kcc.build_commentary_query(title, asr, instruct) == \
            jcc.build_commentary_query(title, asr, instruct)
    chunks = [[0, 1, "He runs ..."], [1, 2, "  ... "], [2, 3, "and scores"]]
    assert livesports3kcc.join_commentary(chunks) == jcc.join_commentary(chunks)


def test_subtitles_match_jax(tmp_path):
    srt = ("1\n00:00:01,000 --> 00:00:02,500\n<i>Hello</i> there\n\n"
           "2\n00:00:03.250 --> 00:00:04,000\nsecond line\nwraps\n\n"
           "garbage block\n\n3\n00:01:00,000 --> 01:00:00,001\n<b></b>\n\n"
           "00:02:00,000 --> 00:02:01,000\nno index\n")
    (tmp_path / "vid0.srt").write_text(srt)
    path = str(tmp_path / "vid0.srt")
    assert subtitles.parse_srt(path) == jsubs.parse_srt(path)
    assert subtitles.srt_text(path) == jsubs.srt_text(path)
    bench = write_jsonl(tmp_path / "b.jsonl", [{"video_id": "vid0"}, {"video_id": "vid1"}])
    for mod, out in ((subtitles, "port.jsonl"), (jsubs, "jax.jsonl")):
        assert mod.add_subtitles(bench, str(tmp_path), str(tmp_path / out)) == 1
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()


# --- commentary on the engine ----------------------------------------------------

EVENTS = [
    {"video_id": "m0", "event_id": "e0", "begin": 10.0, "end": 14.0, "title": "Cup final",
     "preASR": "kick off", "video": "v0.mp4"},
    {"video_id": "m0", "event_id": "e1", "begin": 20.0, "end": 23.0, "title": None,
     "preASR": None, "video": "v1.mp4"},
]


def read_event(event):
    """The event's 2 fps frames (the seeds of its clip): 4 s of 56 x 56."""
    n = int(round((event["end"] - event["begin"]) * 2))
    return synth(n, 56, 56, 10 + EVENTS.index(event))


@pytest.fixture(scope="module")
def engines(models):
    """(JAX engine, port engine) on the hf_tiny weights, fp32, cache_len 1024."""
    from livecc_tpu.engine import LiveCCEngine as JaxEngine

    from livecc_tpu_torch.engine import LiveCCEngine

    params, model = models
    return (JaxEngine(params, jax_tiny_config(), JaxByteTokenizer(), cache_len=1024),
            LiveCCEngine(model, tiny_config(), ByteTokenizer(), cache_len=1024))


def test_livesports3kcc_generate_matches_jax(engines, tmp_path):
    """Two workers' shards, each event's file, the merged JSONL: JAX's bytes."""
    for engine, mod, out in ((engines[0], jcc, "jax"), (engines[1], livesports3kcc, "port")):
        kw = dict(read_clip=read_event, num_workers=2, max_new_tokens=6)
        assert mod.generate(engine, EVENTS, str(tmp_path / out), worker=1, **kw) is None
        merged = mod.generate(engine, EVENTS, str(tmp_path / out), worker=0, **kw)
        assert merged == str(tmp_path / out / "predictions.jsonl")
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    rows = [json.loads(l) for l in open(tmp_path / "port" / "predictions.jsonl")]
    assert [len(r["chunks"]) for r in rows] == [2, 1]        # 6 + 2 frames, then 6


def test_generate_captions_matches_jax(engines, tmp_path):
    for engine, mod, out in ((engines[0], jcaptions, "jax"), (engines[1], captions, "port")):
        assert mod.generate_captions(engine, EVENTS, str(tmp_path / out), read_clip=read_event,
                                     max_new_tokens=8) == str(tmp_path / out / "captions.jsonl")
    assert (tmp_path / "port" / "captions.jsonl").read_bytes() == \
        (tmp_path / "jax" / "captions.jsonl").read_bytes()


# --- the CLI ---------------------------------------------------------------------

def test_cli_runs_on_the_cpu(tmp_path, monkeypatch):
    """``eval.cli.main`` with ``--device cpu`` and the reader swapped for
    the in-memory one: a videomme run writes its report and files, a
    livesports3kcc run its merged predictions. Without CUDA, ``--device
    cuda`` (the default) raises."""
    from livecc_tpu_torch.eval import cli
    from livecc_tpu_torch.vision_io import video_reader

    asked = []
    monkeypatch.setattr(video_reader, "VideoReader", loader(asked))
    bench = write_jsonl(tmp_path / "vm.jsonl", VIDEOMME_ROWS[:3])
    out = str(tmp_path / "vm")
    report = cli.main(["videomme", "--benchmark", bench, "--output_dir", out, "--max_frames", "4",
                       "--batch_size", "2", "--device", "cpu"])
    assert report["n"] == 3 and set(report["duration"]) == {"short", "medium", "long"}
    assert {"results_no_subtitles.txt", "results_no_subtitles.json",
            "videomme_no_subtitles.json", "videomme_shard0.json"} <= set(os.listdir(out))
    preds = json.load(open(os.path.join(out, "videomme_no_subtitles.json")))["predictions"]
    assert len(preds) == 3 and set(preds) <= set("ABCD")
    assert len(asked) == 3 and all(hw == (280, 280) for _, hw in asked)

    events = write_jsonl(tmp_path / "ev.jsonl", [dict(EVENTS[0], begin=0.5, end=1.6)])
    merged = cli.main(["livesports3kcc", "--events", events, "--output_dir",
                       str(tmp_path / "cc"), "--max_new_tokens", "4", "--device", "cpu"])
    rows = [json.loads(l) for l in open(merged)]
    assert len(rows) == 1 and rows[0]["event_id"] == "e0" and len(rows[0]["chunks"]) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["videomme", "--benchmark", bench, "--output_dir", str(tmp_path / "x")])


# --- the blocked plain versions ----------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_plain_versions_equal_the_whole_ones(dtype):
    """``kernel_check``'s blocked K4 forward (query rows in blocks) and K3
    (group by group) against the whole plain versions, with a dropped tile
    failing the same limit."""
    from livecc_tpu_torch.ops.attention import prescaled
    from livecc_tpu_torch.ops.train_attention import train_attention_fwd_plain
    from livecc_tpu_torch.ops.vit_attention import vit_group_attention_plain

    gen = torch.Generator().manual_seed(0)
    s, (hq, hk, d) = 300, (4, 2, 16)
    q, k, v = (torch.randn((1, s, h, d), generator=gen).to(dtype) for h in (hq, hk, hk))
    qs = prescaled(q)
    seg = torch.zeros((1, s), dtype=torch.int32)
    seg[0, :230] = 1                                   # one real segment, then pad
    o, lse = train_attention_fwd_plain(qs, k, v, seg)
    bo, blse = kernel_check.train_attention_fwd_blocked(qs, k, v, seg, rows=64)
    assert kernel_check.close(bo, o, dtype) <= 1.0
    assert kernel_check.close(blse, lse, torch.float32) <= 1.0
    bad, _ = kernel_check.dropped_fwd_tile(qs, k, v, seg, o, lse, 2, 1, 3)
    assert kernel_check.close(bad, o, dtype) > 1.0

    vq, vk, vv = (torch.randn((3, 70, 4, 16), generator=gen).to(dtype) for _ in range(3))
    ref = vit_group_attention_plain(vq, vk, vv)
    assert kernel_check.close(kernel_check.vit_group_attention_blocked(vq, vk, vv), ref,
                              dtype) <= 1.0

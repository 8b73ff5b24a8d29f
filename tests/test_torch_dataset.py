"""The port's training dataset (``livecc_tpu_torch/data/lmm_dataset.py``)
against the JAX package's (``livecc_tpu/data/lmm_dataset.py``).

One seek-indexed JSONL corpus is read by both ``LMMDataset``s with the same
in-memory ``video_loader`` (``SeededClips``: seeded frames served at any
requested size by a deterministic numpy resize, so nothing needs the native
decoder). The corpus holds streaming rows with ``video_start`` /
``video_end``, a row whose tail turns are empty, a plain video-QA row and
an image row, read with ``with_context`` on and off, under ``ByteTokenizer``
and under ``HFTokenizer`` on ``tests/fixtures/tiny_tokenizer.json``:
``input_ids``, ``labels``, ``position_ids`` and the grids must be equal and
the patches within fp32 1e-6. A corrupt seek resamples to the same index
under the same seed, and the port counts the retry.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.data import lmm_dataset as jds
from livecc_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from livecc_tpu.data.tokenizer import HFTokenizer as JaxHFTokenizer

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data import lmm_dataset as pds
from livecc_tpu_torch.data.tokenizer import ByteTokenizer, HFTokenizer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
TOKENIZER = os.path.join(HERE, "fixtures", "tiny_tokenizer.json")
# path -> (frames, fps, source (h, w), seed)
CLIPS = {"clip_a.mp4": (48, 4.0, (60, 84), 1), "clip_b.mp4": (30, 2.0, (56, 56), 2),
         "clip_c.mp4": (20, 5.0, (42, 70), 3)}


class SeededVideo:
    """``VideoReader``'s API over seeded frames: ``get_batch`` serves any
    ``out_hw`` by nearest-neighbour index maps (deterministic numpy)."""

    def __init__(self, n, fps, hw, seed):
        self.frames = np.random.RandomState(seed).randint(0, 256, (n, *hw, 3), dtype=np.uint8)
        self.avg_fps, self.frame_size = float(fps), tuple(hw)
        self.pts_seconds = np.arange(n) / self.avg_fps

    def __len__(self):
        return len(self.frames)

    def get_batch(self, indices, out_hw=None):
        h, w = out_hw or self.frame_size
        rows = np.arange(h) * self.frame_size[0] // h
        cols = np.arange(w) * self.frame_size[1] // w
        return self.frames[np.asarray(indices)][:, rows][:, :, cols]


class SeededClips:
    """The ``video_loader`` both datasets share: path -> ``SeededVideo``."""

    def __call__(self, path):
        return SeededVideo(*CLIPS[os.path.basename(path)])


def words(n, start=0.0, pace=0.4):
    """``n`` ASR triples [start, end, word] at ``pace`` s a word."""
    return [[start + i * pace, start + i * pace + 0.3, f"w{i}"] for i in range(n)]


def stream_row(clip, query, stream, **span):
    return [{"role": "user", "content": [{"type": "video", "video": clip, **span}, query]},
            {"role": "assistant", "content": [{"type": "text", "text_stream": stream}]}]


def corpus_rows(root):
    from PIL import Image

    image = str(root / "frame.png")
    Image.fromarray(np.random.RandomState(4).randint(0, 256, (40, 60, 3), dtype=np.uint8)
                    ).save(image)
    titled = {"type": "text", "text": "commentate", "title": "Cup final"}
    previous = {"type": "text", "text": "go on", "title": "t", "previous": "earlier words"}
    return [
        # streaming, clipped to [2, 10] s of a 12 s clip at 4 fps
        stream_row("clip_a.mp4", titled, words(20, start=2.0), video_start=2.0, video_end=10.0),
        # streaming, words only in the first 4 s of 15 and one after the clip
        # ends: the empty tail turns are trimmed
        stream_row("clip_b.mp4", previous, words(8) + [[100.0, 100.3, "late"]]),
        # streaming over the whole clip, no context fields
        stream_row("clip_c.mp4", {"type": "text", "text": "describe"}, words(9, pace=0.45)),
        # plain video QA
        [{"role": "user", "content": [{"type": "video", "video": "clip_b.mp4"},
                                      {"type": "text", "text": "what happens?"}]},
         {"role": "assistant", "content": [{"type": "text", "text": "a goal"}]}],
        # an image row and a string-content turn
        [{"role": "user", "content": [{"type": "image", "image": image},
                                      {"type": "text", "text": "what is shown?"}]},
         {"role": "assistant", "content": "a pitch"}],
    ]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    path = str(root / "anns.jsonl")
    with open(path, "w") as f:
        for row in corpus_rows(root):
            f.write(json.dumps(row) + "\n")
    pds.write_seek_index(path)
    return path


def configs(tokenizer):
    """(JAX, port) tiny configs whose special ids are the tokenizer's."""
    jcfg, pcfg = jax_tiny_config(), tiny_config()
    if tokenizer == "byte":
        return jcfg, pcfg, JaxByteTokenizer(), ByteTokenizer()
    jtok, ptok = JaxHFTokenizer(TOKENIZER), HFTokenizer(TOKENIZER)
    ids = {f: ptok.token_to_id(t) for f, t in (
        ("im_start_token_id", "<|im_start|>"), ("im_end_token_id", "<|im_end|>"),
        ("vision_start_token_id", "<|vision_start|>"),
        ("vision_end_token_id", "<|vision_end|>"), ("image_token_id", "<|image_pad|>"),
        ("video_token_id", "<|video_pad|>"))}
    return dataclasses.replace(jcfg, **ids), dataclasses.replace(pcfg, **ids), jtok, ptok


def datasets(corpus, tokenizer, with_context, **kw):
    jcfg, pcfg, jtok, ptok = configs(tokenizer)
    loader = SeededClips()
    common = dict(annotation_paths=[corpus], with_context=with_context, video_loader=loader, **kw)
    return (jds.LMMDataset(tokenizer=jtok, cfg=jcfg, **common),
            pds.LMMDataset(tokenizer=ptok, cfg=pcfg, **common))


def assert_samples_equal(port, ref):
    assert port.keys() == ref.keys()
    for key in ("input_ids", "labels", "position_ids", "video_grid_thw", "image_grid_thw"):
        if ref[key] is None:
            assert port[key] is None, key
        else:
            assert port[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
    for key in ("pixel_patches", "image_patches"):
        if ref[key] is None:
            assert port[key] is None, key
        else:
            np.testing.assert_allclose(port[key], ref[key], rtol=0, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("with_context", [False, True])
@pytest.mark.parametrize("tokenizer", ["byte", "hf"])
def test_samples_match_jax(corpus, tokenizer, with_context):
    """Every row of the corpus through both datasets: the same sample."""
    jax_ds, port_ds = datasets(corpus, tokenizer, with_context)
    assert len(port_ds) == len(jax_ds) == 5
    for i in range(len(jax_ds)):
        ref, out = jax_ds.getitem(i), port_ds[i]
        assert_samples_equal(out, ref)
        sup = out["labels"][0] != -100
        assert sup.any() and (out["labels"][0][sup] == out["input_ids"][0][sup]).all()
    assert port_ds.retries == 0


def test_stream_rows_interleave_and_trim(corpus):
    """What the parity rests on: the streaming rows give a first user turn
    of 6 frames (3 s at 2 fps) and then one of 2 frames a second; the
    clipped row reads 18 frames of [2, 10] s; the row whose words stop at
    3.1 s (one more after the clip's end keeps the cursor from repeating
    the last word) keeps 2 of its 13 turns, the empty tail trimmed."""
    _, port_ds = datasets(corpus, "byte", False)
    convs = [port_ds.preprocess_conversation_stream(port_ds.load_conversation(i))
             for i in range(3)]
    assert [len(turns) // 2 for turns, _ in convs] == [7, 2, 2]
    assert [[len(c) for c in clips] for _, clips in convs][0] == [6] + [2] * 6
    assert all(t["content"][0]["text"] != " ..." for turns, _ in convs for t in turns[1::2])
    x = port_ds[0]
    assert x["video_grid_thw"].tolist() == [[3, 18, 24]] + [[1, 18, 24]] * 6
    # the system turn and 7 user / assistant pairs
    assert (x["input_ids"][0] == port_ds.cfg.im_start_token_id).sum() == 1 + 2 * 7


@pytest.mark.parametrize("tokenizer", ["byte", "hf"])
def test_image_ndarray_matches_jax(corpus, tokenizer, monkeypatch):
    """An image given as an ndarray (``_load_image``'s array path): the
    image row with the file replaced by its pixels, in both datasets."""
    image = np.random.RandomState(5).randint(0, 256, (28, 56, 3), dtype=np.uint8)
    conv = [{"role": "user", "content": [{"type": "image", "image": image},
                                         {"type": "text", "text": "and here?"}]},
            {"role": "assistant", "content": [{"type": "text", "text": "a corner kick"}]}]
    jax_ds, port_ds = datasets(corpus, tokenizer, False)
    for ds in (jax_ds, port_ds):
        monkeypatch.setattr(ds, "load_conversation", lambda index: conv)
    ref, out = jax_ds.getitem(0), port_ds[0]
    assert out["image_grid_thw"].tolist() == [[1, 2, 4]]
    assert_samples_equal(out, ref)


def test_corrupt_seek_resamples_as_jax_and_is_counted(corpus):
    """A seek past the end gives an empty line, which fails to parse: both
    datasets draw the same replacement from the same seed (row 3 under seed
    0), and the port counts one retry; with no retries left the error
    comes through, uncounted."""
    jax_ds, port_ds = datasets(corpus, "byte", False, seed=0, max_retries=5)
    for ds in (jax_ds, port_ds):
        ds.handles[1] = (corpus, 10**9)
    ref, out = jax_ds[1], port_ds[1]
    assert_samples_equal(out, ref)
    assert port_ds.retries == 1
    assert port_ds._rng.getstate() == jax_ds._rng.getstate()
    one = datasets(corpus, "byte", False, max_retries=1)[1]
    one.handles[0] = (corpus, 10**9)
    with pytest.raises(json.JSONDecodeError):
        one[0]
    assert one.retries == 0


# --- the helpers -------------------------------------------------------------

@pytest.mark.parametrize("stream,timestamp,start", [
    ([[0.0, 0.4, "a"], [0.5, 0.9, "b"], [1.0, 1.4, "c"]], 0.95, 0),
    ([[0.0, 0.4, "a"], [0.5, 0.9, "b"], [1.0, 1.4, "c"]], 2.0, 2),
    ([[0.0, 0.4, " a "], [0.5, 0.9, ""], [1.0, 1.4, "c"]], 1.4, 0),
    ([[0.0, 0.4, "a"]], 0.1, 0),
    ([], 3.0, 0),
    ([[0.0, 0.4, "a"], [0.5, 0.9, "b"]], 5.0, 2),
])
def test_phrase_before_timestamp_matches_jax(stream, timestamp, start):
    assert (pds.get_phrase_before_timestamp(stream, timestamp, start)
            == jds.get_phrase_before_timestamp(stream, timestamp, start))


@pytest.mark.parametrize("lines", [["{}"], ['{"a": 1}', "[1, 2]", '"x"'], ["[]"] * 5])
def test_seek_index_and_last_line_match_jax(tmp_path, lines):
    """``write_seek_index`` appends the same index line, and
    ``read_last_line`` reads it back, in both packages."""
    paths = []
    for name, mod in (("port", pds), ("jax", jds)):
        path = tmp_path / f"{name}.jsonl"
        path.write_text("".join(line + "\n" for line in lines))
        mod.write_seek_index(str(path))
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    last = pds.read_last_line(str(paths[0]))
    assert last == jds.read_last_line(str(paths[0]))
    seeks = json.loads(last)
    with open(paths[0]) as f:
        for seek, line in zip(seeks, lines):
            f.seek(seek)
            assert f.readline() == line + "\n"


def test_data_arguments_match_jax():
    assert dataclasses.asdict(pds.DataArguments()) == dataclasses.asdict(jds.DataArguments())


def test_video_reader_clip_matches_jax(tmp_path):
    """An encoded clip read through both packages' ``VideoReader`` (the
    default ``video_loader``): the same samples. Skips without the native
    decoder (FFmpeg development libraries)."""
    from livecc_tpu.vision_io import video_reader as jvr
    from livecc_tpu_torch.vision_io import video_reader as pvr

    if not (jvr.is_available() and pvr.is_available()):
        pytest.skip("the native video decoder is not available (FFmpeg development libraries)")
    clip = str(tmp_path / "clip.mp4")
    pvr.encode_test_video(clip, np.random.RandomState(6).randint(
        0, 256, (40, 56, 84, 3), dtype=np.uint8), fps=8)
    path = str(tmp_path / "anns.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps(stream_row(clip, {"type": "text", "text": "go"}, words(12))) + "\n")
    pds.write_seek_index(path)
    ref = jds.LMMDataset(annotation_paths=[path], tokenizer=JaxByteTokenizer(),
                         cfg=jax_tiny_config())[0]
    out = pds.LMMDataset(annotation_paths=[path], tokenizer=ByteTokenizer(), cfg=tiny_config())[0]
    assert_samples_equal(out, ref)

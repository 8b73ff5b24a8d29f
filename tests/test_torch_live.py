"""The port's front door against the JAX package's, on the CPU.

The video reader (the port's own copy of the native decoder), the
visual-token budget (a copy, pinned here), the host ``patchify_video``, the
wall-clock driver ``engine/live.py`` and ``demo/cli.py``, each against its
JAX original on the same clip: an mpeg4 clip encoded by the decoder from
numpy frames. The live session runs the hf_tiny weights in fp32, greedy,
with ``cache_len=1024`` (as ``tests/test_live.py``), and must give JAX's
spans and texts exactly. Tests that decode video skip where either decoder
does not build (no FFmpeg development libraries), as ``tests/test_live.py``.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from safetensors.numpy import save_file

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from livecc_tpu.vision_io import budget as jbudget
from livecc_tpu.vision_io import video_reader as jvr
from livecc_tpu.vision_io.patchify import patchify_video as jax_patchify_video

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.vision_io import budget as pbudget
from livecc_tpu_torch.vision_io import video_reader as pvr
from livecc_tpu_torch.vision_io.patchify import device_patchify, patchify_video
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "goldens", "hf_tiny.npz")
TOKENIZER = os.path.join(HERE, "fixtures", "tiny_tokenizer.json")


@pytest.fixture(scope="module")
def decoders():
    if not (pvr.is_available() and jvr.is_available()):
        pytest.skip("native decoder unavailable (FFmpeg development libraries)")


@pytest.fixture(scope="module")
def video(decoders, tmp_path_factory):
    """8 s at 10 fps of 56x56 noise, as tests/test_live.py."""
    path = str(tmp_path_factory.mktemp("live") / "clip.mp4")
    frames = np.random.RandomState(0).randint(0, 255, size=(80, 56, 56, 3), dtype=np.uint8)
    pvr.encode_test_video(path, frames, fps=10)
    return path


def golden_state():
    g = np.load(GOLDEN)
    return {k[len("state::"):]: g[k] for k in g.files if k.startswith("state::")}


# --- video reader ----------------------------------------------------------

@pytest.mark.parametrize("source", ["path", "bytes"])
def test_video_reader_matches_jax(video, source):
    src = video if source == "path" else open(video, "rb").read()
    port, ref = pvr.VideoReader(src), jvr.VideoReader(src)
    assert len(port) == len(ref) == 80
    assert port.avg_fps == ref.avg_fps
    assert port.frame_size == ref.frame_size == (56, 56)
    np.testing.assert_array_equal(port.pts_seconds, ref.pts_seconds)
    idx = [0, 3, 3, 7, 40, 41, 79]
    np.testing.assert_array_equal(port.get_batch(idx), ref.get_batch(idx))
    for hw in ((28, 28), (84, 112)):
        np.testing.assert_array_equal(port.get_batch(idx, out_hw=hw), ref.get_batch(idx, out_hw=hw))
    port.close()


def test_encoder_writes_what_jax_writes(decoders, tmp_path):
    frames = np.random.RandomState(1).randint(0, 255, size=(6, 28, 42, 3), dtype=np.uint8)
    pvr.encode_test_video(str(tmp_path / "p.mp4"), frames, fps=4)
    jvr.encode_test_video(str(tmp_path / "j.mp4"), frames, fps=4)
    assert (tmp_path / "p.mp4").read_bytes() == (tmp_path / "j.mp4").read_bytes()


# --- budget (a copy of the JAX module) ---------------------------------------

SIZES = [(56, 56), (308, 560), (720, 1280), (1080, 1920), (30, 4000), (3000, 17)]


@pytest.mark.parametrize("hw", SIZES)
def test_smart_resize_and_budget_methods_match(hw):
    h, w = hw
    for kw in ({}, dict(min_pixels=100 * 28 * 28, max_pixels=384 * 28 * 28),
               dict(factor=14, min_pixels=3136, max_pixels=10**7)):
        assert pbudget.smart_resize(h, w, **kw) == jbudget.smart_resize(h, w, **kw)
    pb, jb = pbudget.VisionBudget(), jbudget.VisionBudget()
    assert pb.image_target(h, w) == jb.image_target(h, w)
    for n in (2, 8, 480):
        assert pb.video_frame_max_pixels(n) == jb.video_frame_max_pixels(n)
        assert pb.spatial_target(h, w, n) == jb.spatial_target(h, w, n)


@pytest.mark.parametrize("total,fps", [(80, 10.0), (300, 30.0), (7, 2.0), (5000, 25.0)])
def test_frame_counts_match(total, fps):
    for kw in ({}, dict(nframes=6), dict(fps=1.0), dict(min_frames=8, max_frames=64)):
        try:
            want = jbudget.smart_nframes(total, fps, **kw)
        except ValueError:
            with pytest.raises(ValueError):
                pbudget.smart_nframes(total, fps, **kw)
            continue
        assert pbudget.smart_nframes(total, fps, **kw) == want
    n = min(total, 16)
    np.testing.assert_array_equal(pbudget.linspace_sample(total, n), jbudget.linspace_sample(total, n))
    assert pbudget.grid_thw_for(n, 308, 560) == jbudget.grid_thw_for(n, 308, 560)
    assert pbudget.num_video_tokens((n // 2, 22, 40)) == jbudget.num_video_tokens((n // 2, 22, 40))


@pytest.mark.parametrize("max_frames", [480, 7])
@pytest.mark.parametrize("drop_last", [True, False])
def test_strict_fps_sample_matches(max_frames, drop_last):
    pts = np.cumsum(np.random.RandomState(2).uniform(0.02, 0.09, size=300))
    pb = pbudget.VisionBudget(fps_max_frames=max_frames)
    jb = jbudget.VisionBudget(fps_max_frames=max_frames)
    for a, b in zip(pbudget.strict_fps_sample(pts, budget=pb, drop_last=drop_last),
                    jbudget.strict_fps_sample(pts, budget=jb, drop_last=drop_last)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("start", [0.0, 2.5, 7.9])
def test_snap_timestamps_to_pts_matches(start):
    pts = np.arange(80) / 10.0
    for index_from in (0, 20, 79):
        ts = np.arange(start, start + 2.6, 0.5)
        got = pbudget.snap_timestamps_to_pts(ts, pts, index_from=index_from)
        want = jbudget.snap_timestamps_to_pts(ts, pts, index_from=index_from)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        assert got[2] == want[2]


# --- host patchify -------------------------------------------------------------

@pytest.mark.parametrize("t", [2, 5])
def test_patchify_video_matches_jax_and_device_patchify(t):
    frames = np.random.RandomState(t).randint(0, 256, size=(t, 56, 84, 3), dtype=np.uint8)
    tchw = frames.transpose(0, 3, 1, 2)
    flat, grid = patchify_video(tchw)
    ref, ref_grid = jax_patchify_video(tchw)
    assert grid == ref_grid == (-(-t // 2), 4, 6) and flat.dtype == np.float32
    np.testing.assert_array_equal(flat, ref)
    np.testing.assert_array_equal(flat, device_patchify(torch.from_numpy(frames)).numpy())
    raw, _ = patchify_video(tchw, normalize=False)
    np.testing.assert_array_equal(raw, jax_patchify_video(tchw, normalize=False)[0])


# --- live session ----------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the hf_tiny weights, fp32, cache_len 1024."""
    from livecc_tpu.engine import LiveCCEngine as JaxEngine
    from livecc_tpu.models import qwen2_vl as jm

    from livecc_tpu_torch.engine import LiveCCEngine
    from livecc_tpu_torch.models.qwen2_vl.convert import convert_state_dict

    state = golden_state()
    jax_engine = JaxEngine(jm.convert_state_dict(state, jax_tiny_config()), jax_tiny_config(),
                           JaxByteTokenizer(), cache_len=1024)
    port_engine = LiveCCEngine(convert_state_dict(state, tiny_config()), tiny_config(),
                               ByteTokenizer(), cache_len=1024)
    return jax_engine, port_engine


def test_live_cc_matches_jax(engines, video):
    from livecc_tpu.engine.live import LiveCC as JaxLiveCC

    from livecc_tpu_torch.engine.live import LiveCC

    outs = []
    for live in (JaxLiveCC(engines[0]), LiveCC(engines[1])):
        session = live.open(video)
        out = []
        for t in range(9):
            out.extend(live.live_cc(session, float(t), query="q"))
            if session.video_end:
                break
        outs.append((out, session.last_pts_index, session.resized_hw))
    assert outs[1] == outs[0]
    spans = [span for span, _ in outs[1][0]]
    assert spans[0] == (0.0, 3.0) and len(spans) >= 5
    for (_, a1), (b0, _) in zip(spans, spans[1:]):
        assert b0 == pytest.approx(a1, abs=0.101)


def test_video_qa_matches_jax(engines, video):
    from livecc_tpu.engine import GenerationParams as JaxGen
    from livecc_tpu.engine.live import LiveCC as JaxLiveCC

    from livecc_tpu_torch.engine import GenerationParams
    from livecc_tpu_torch.engine.live import LiveCC

    answers = []
    for live, gen_cls in ((JaxLiveCC(engines[0]), JaxGen), (LiveCC(engines[1]), GenerationParams)):
        cfg = live.engine.cfg
        gen = gen_cls(max_new_tokens=6, eos_token_id=cfg.eos_token_id,
                      pad_token_id=cfg.pad_token_id, repetition_penalty=1.05)
        session = live.open(video)
        a1 = live.video_qa(session, "what is shown?", gen=gen)
        a2 = live.video_qa(session, "and then?", gen=gen)
        answers.append((a1, a2, int(session.stream.cache.offset[0])))
    assert answers[1] == answers[0]


def test_live_cc_through_a_video_loader(engines, video):
    """``video_loader`` serves frames in ``VideoReader``'s API: the decoded
    frames, served from memory, give the same session as the decoder."""
    from livecc_tpu_torch.engine.live import LiveCC

    hw = LiveCC(engines[1]).open(video).resized_hw
    reader = pvr.VideoReader(video)
    frames, pts = reader.get_batch(range(len(reader)), out_hw=hw), reader.pts_seconds

    class Frames:
        avg_fps, frame_size, pts_seconds = reader.avg_fps, reader.frame_size, pts

        def __len__(self):
            return len(pts)

        def get_batch(self, idx, out_hw=None):
            assert out_hw == hw
            return frames[np.asarray(idx)]

    outs = []
    for live in (LiveCC(engines[1]), LiveCC(engines[1], video_loader=lambda _: Frames())):
        session = live.open(video)
        outs.append([x for t in range(5) for x in live.live_cc(session, float(t), query="q")])
    assert outs[0] == outs[1] and [span for span, _ in outs[0]] == [(0.0, 3.0), (3.0, 4.0)]


# --- the CLI ----------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The hf_tiny weights as an HF checkpoint directory with the tiny
    tokenizer.json, its special-token ids in config.json."""
    from tokenizers import Tokenizer

    path = tmp_path_factory.mktemp("cli") / "tiny"
    path.mkdir()
    save_file(golden_state(), str(path / "model.safetensors"))
    shutil.copy(TOKENIZER, str(path / "tokenizer.json"))
    tok = Tokenizer.from_file(TOKENIZER)
    ids = {n: tok.token_to_id(f"<|{n}|>") for n in
           ("vision_start", "vision_end", "video_pad", "image_pad", "im_end", "endoftext")}
    t, v = tiny_config().text, tiny_config().vision
    cfg = dict(vocab_size=t.vocab_size, hidden_size=t.hidden_size,
               intermediate_size=t.intermediate_size, num_hidden_layers=t.num_hidden_layers,
               num_attention_heads=t.num_attention_heads, num_key_value_heads=t.num_key_value_heads,
               rope_scaling={"type": "mrope", "mrope_section": list(t.mrope_section)},
               bos_token_id=ids["endoftext"], eos_token_id=ids["im_end"],
               vision_start_token_id=ids["vision_start"], vision_end_token_id=ids["vision_end"],
               image_token_id=ids["image_pad"], video_token_id=ids["video_pad"],
               vision_config=dict(depth=v.depth, embed_dim=v.embed_dim, num_heads=v.num_heads,
                                  hidden_size=v.hidden_size))
    with open(path / "config.json", "w") as f:
        json.dump(cfg, f)
    return str(path)


def test_cli_writes_jax_json_in_fp32(video, checkpoint, tmp_path, monkeypatch):
    """Both CLIs on the checkpoint directory, each loading it through its
    own package, with the weights and the cache kept in fp32 (the CLIs load
    bf16, whose rounding parts the two at this random model's near-tied
    logits): the same result JSON."""
    cli_json_pair(video, checkpoint, tmp_path, monkeypatch, [])


def test_cli_quantize_weights_writes_jax_json_in_fp32(video, checkpoint, tmp_path, monkeypatch):
    """The same with ``--quantize-weights`` on both CLIs: each engine
    quantizes the fp32 checkpoint to the same int8 codes (JAX's TPU serving
    configuration); the same result JSON."""
    cli_json_pair(video, checkpoint, tmp_path, monkeypatch, ["--quantize-weights"])


def cli_json_pair(video, checkpoint, tmp_path, monkeypatch, flags):
    """Run both CLIs with ``flags`` in fp32 (see above) and compare their JSON."""
    import livecc_tpu.engine as jengine
    from livecc_tpu.demo import cli as jcli
    from livecc_tpu.models.qwen2_vl import convert as jconvert

    import livecc_tpu_torch.engine as pengine
    from livecc_tpu_torch.demo import cli
    from livecc_tpu_torch.models.qwen2_vl import convert

    real_jload, real_pload = jconvert.load_safetensors_dir, convert.load_checkpoint
    jengine_cls, pengine_cls = jengine.LiveCCEngine, pengine.LiveCCEngine
    monkeypatch.setattr(jconvert, "load_safetensors_dir",
                        lambda path, cfg, dtype=None: real_jload(path, cfg, dtype=jnp.float32))
    monkeypatch.setattr(convert, "load_checkpoint",
                        lambda path, device, dtype=None: real_pload(path, device, torch.float32))
    monkeypatch.setattr(jengine, "LiveCCEngine",
                        lambda *a, **k: jengine_cls(*a, **{**k, "cache_dtype": jnp.float32}))
    monkeypatch.setattr(pengine, "LiveCCEngine",
                        lambda *a, **k: pengine_cls(*a, **{**k, "cache_dtype": torch.float32}))
    args = ["--video", video, "--model", checkpoint, "--seconds", "6", "--max-new-tokens", "6",
            *flags]
    jcli.main(args + ["--output", str(tmp_path / "jax.json")])
    cli.main(args + ["--output", str(tmp_path / "port.json"), "--device", "cpu"])
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == ref
    assert ref["video_path"] == video and len(ref["commentaries"]) == 4


def test_cli_on_the_cpu_loads_bf16(video, checkpoint, tmp_path):
    """The port's CLI as a user runs it (bf16 weights and cache, the
    checkpoint's tokenizer) with --device cpu: JAX's spans, text in every
    chunk. Without CUDA, --device cuda raises."""
    from livecc_tpu_torch.demo import cli

    out = tmp_path / "out.json"
    result = cli.main(["--video", video, "--model", checkpoint, "--seconds", "6",
                       "--max-new-tokens", "6", "--output", str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == result
    assert [c[:2] for c in result["commentaries"]] == [[0.0, 3.0], [3.0, 4.0], [4.0, 5.0],
                                                      [5.0, 6.0]]
    assert all(c[2] for c in result["commentaries"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--video", video, "--model", checkpoint])

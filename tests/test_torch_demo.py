"""The port's web demo, renderer, TTS and ``device_preprocess`` against JAX's, on the CPU.

``audio/tts.py`` is a copy: its phonemes and samples must equal JAX's bit
for bit. ``demo/render.py`` draws the same bubble pixels and, where both
native decoders build (FFmpeg development libraries; as
``tests/test_torch_live.py``), writes the same mp4 bytes. ``demo/app.py``
serves the same ``/tick`` JSON bodies and QA texts as JAX's on the hf_tiny
weights in fp32 (also gated on the decoders: the clip is an mp4), and,
never skipped, its server over frames in memory (a ``video_loader``) gives
a direct ``LiveCC`` run's commentary, serializes ticks fired from threads
at once, answers 404 for unknown paths and raises without a card.
``vision_io.device_preprocess`` is held to JAX's within 1e-5.
"""

import json
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from livecc_tpu.audio import tts as jtts
from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from livecc_tpu.demo import render as jrender
from livecc_tpu.vision_io import video_reader as jvr
from livecc_tpu.vision_io.patchify import device_preprocess as jax_device_preprocess

from livecc_tpu_torch.audio import tts
from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.demo import app, cli
from livecc_tpu_torch.vision_io import device_preprocess
from livecc_tpu_torch.vision_io import video_reader as pvr
from torch_demo_http import get, npy_loader, post, serving, write_clip
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "goldens", "hf_tiny.npz")
QUERY = "describe"
TICKS = (2.0, 3.0, 4.0, 6.5, 8.0)
QUESTIONS = ("what is shown?", "and then?")
FPS = 10.0


def golden_state():
    g = np.load(GOLDEN)
    return {k[len("state::"):]: g[k] for k in g.files if k.startswith("state::")}


def clip_frames(seed: int = 0) -> np.ndarray:
    """8 s at 10 fps of 56x56 noise (``tests/test_torch_live.py``'s clip)."""
    return np.random.RandomState(seed).randint(0, 255, size=(80, 56, 56, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def decoders():
    if not (pvr.is_available() and jvr.is_available()):
        pytest.skip("native decoder unavailable (FFmpeg development libraries)")


@pytest.fixture(scope="module")
def video(decoders, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("demo") / "clip.mp4")
    pvr.encode_test_video(path, clip_frames(), fps=int(FPS))
    return path


# --- TTS (a copy of the JAX module) ----------------------------------------------

SENTENCES = [
    "and the striker scores a goal", "go", "Time 3 to 4!", "Time=3.0-4.0s",
    "house mouse praise", "raise aide game", "What a finish, into the top corner!",
    "The keeper's save; 90 minutes, 2-1.", "",
]


@pytest.mark.parametrize("text", SENTENCES)
def test_tts_bit_equal_to_jax(text):
    assert tts.RATE == jtts.RATE
    assert tts.text_to_phonemes(text) == jtts.text_to_phonemes(text)
    wav, rate = tts.synthesize(text)
    ref, ref_rate = jtts.synthesize(text)
    assert rate == ref_rate and wav.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(wav, ref)


def test_tts_contract_and_its_knobs_match_jax():
    """``tests/test_demo_render.py``'s contract on the port: rate, dtype,
    level, determinism, length order; every word speakable. Other f0 and
    seed give JAX's samples too."""
    wav, rate = tts.synthesize("and the striker scores a goal")
    assert rate == 16000 and wav.dtype == np.float32
    assert 0.2 < np.max(np.abs(wav)) <= 0.8
    assert len(wav) > rate // 2
    np.testing.assert_array_equal(wav, tts.synthesize("and the striker scores a goal")[0])
    assert len(tts.synthesize("go")[0]) < len(wav)
    assert tts.text_to_phonemes("Time 3 to 4!")
    for word in ("house", "mouse", "praise", "raise", "aide", "game"):
        assert len(tts.synthesize(word)[0]) > 0, word
    for kw in (dict(f0=150.0), dict(seed=3)):
        np.testing.assert_array_equal(tts.synthesize("the corner kick", **kw)[0],
                                      jtts.synthesize("the corner kick", **kw)[0])


# --- render ---------------------------------------------------------------------

LONG = ("a long commentary line that cannot fit on one line of this narrow frame and so "
        "wraps over several lines of the bubble")


@pytest.mark.parametrize("anchor,text", [("top", "what happens in this clip?"),
                                         ("bottom", "things begin"), ("bottom", ""),
                                         ("top", LONG)])
def test_draw_bubble_pixels_match_jax(anchor, text):
    from PIL import Image

    from livecc_tpu_torch.demo import render

    frame = Image.fromarray(np.random.RandomState(4).randint(0, 255, (96, 128, 3), np.uint8))
    got = np.asarray(render.draw_bubble(frame, text, anchor=anchor))
    want = np.asarray(jrender.draw_bubble(frame, text, anchor=anchor))
    np.testing.assert_array_equal(got, want)
    assert (got != np.asarray(frame)).any() == bool(text)
    if text == LONG:
        draw = render.ImageDraw.Draw(Image.new("RGBA", (128, 96)))
        assert len(render._wrap(draw, text, render._font(18), 128 - 56)) > 2


def tone(text):
    """A 0.5 s 440 Hz tone for every commentary (``tests/test_demo_render.py``)."""
    return (0.4 * np.sin(2 * np.pi * 440 * np.arange(8000) / 16000)).astype(np.float32), 16000


@pytest.mark.parametrize("voice", ["tone", "builtin", "none"])
def test_render_writes_what_jax_writes(video, tmp_path, voice):
    from livecc_tpu_torch.demo import render

    result = {"video_path": video, "query": "what happens in this clip?",
              "commentaries": [[0.0, 3.0, "things begin"], [3.0, 4.0, "the striker scores"]]}
    rj = tmp_path / "result.json"
    rj.write_text(json.dumps(result))
    out = {}
    for name, mod in (("port", render), ("jax", jrender)):
        tts_arg = {"tone": tone, "builtin": "default", "none": None}[voice]
        out[name] = str(tmp_path / f"{name}.mp4")
        assert mod.render_commentary_video(str(rj), out[name], fps=5, max_seconds=4.0,
                                           tts=tts_arg) == out[name]
    assert open(out["port"], "rb").read() == open(out["jax"], "rb").read()
    assert len(pvr.VideoReader(out["port"])) == 1 + 5 * 4
    if voice != "none":
        assert len(pvr.load_audio(out["port"], 16000)) >= 4 * 16000


# --- the web demo -----------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the hf_tiny weights, fp32, cache_len 1024."""
    from livecc_tpu.engine import LiveCCEngine as JaxEngine
    from livecc_tpu.models import qwen2_vl as jm

    from livecc_tpu_torch.engine import LiveCCEngine
    from livecc_tpu_torch.models.qwen2_vl.convert import convert_state_dict

    state = golden_state()
    return (JaxEngine(jm.convert_state_dict(state, jax_tiny_config()), jax_tiny_config(),
                      JaxByteTokenizer(), cache_len=1024, cache_dtype=jnp.float32),
            LiveCCEngine(convert_state_dict(state, tiny_config()), tiny_config(),
                         ByteTokenizer(), cache_len=1024, cache_dtype=torch.float32))


def test_http_matches_jax(video, engines, monkeypatch):
    """Both servers on 127.0.0.1 get the page, the video, ticks at TICKS
    and two questions: the same video bytes, tick bodies and answers."""
    from livecc_tpu.demo import app as japp
    from livecc_tpu.demo import cli as jcli

    calls = []
    monkeypatch.setattr(jcli, "build_engine", lambda *a, **k: engines[0])
    monkeypatch.setattr(cli, "build_engine",
                        lambda path, **k: calls.append((path, k)) or engines[1])
    seen = {}
    for name, mod, kw in (("jax", japp, {}), ("port", app, {"device": "cpu"})):
        server = mod.DemoServer(video, None, QUERY, **kw)
        with serving(server, mod.make_handler) as url:
            seen[name] = (get(url + "/").decode(), get(url + "/video"),
                          [get(f"{url}/tick?t={t}") for t in TICKS],
                          [post(url + "/qa", q) for q in QUESTIONS])
    assert calls == [(None, dict(speculative=False, device="cpu", tokenizer=None,
                                 quantize_weights=None))]
    (jpage, jvid, jticks, janswers), (page, vid, ticks, answers) = seen["jax"], seen["port"]
    assert page.replace("<title>LiveCC demo</title>", "<title>LiveCC TPU demo</title>") == jpage
    assert vid == jvid == open(video, "rb").read()
    assert ticks == jticks and answers == janswers
    bubbles = [json.loads(body) for body in ticks]
    assert bubbles[0][0][0] == [0.0, 3.0] and bubbles[1] == [] and bubbles[-1][-1][0][1] == 8.0
    assert sum(len(b) for b in bubbles) >= 5 and all(a for a in answers)


@pytest.fixture
def npy_clip(tmp_path, monkeypatch):
    """A clip in an .npy file (what ``/video`` serves is the file the session
    reads). ``build_engine`` keeps its tiny random model but starts the cache
    at 1024 positions (the plain attention reads the whole cache: 8192 takes
    6x as long)."""
    build_engine = cli.build_engine
    monkeypatch.setattr(cli, "build_engine", lambda *a, **k: build_engine(*a, **k, cache_len=1024))
    return write_clip(str(tmp_path / "clip.npy")), npy_loader


def admitted(server) -> list:
    """Wrap ``server.live.live_cc``: the list it returns records each
    tick's ``t`` in the order the lock admitted it."""
    order, live_cc = [], server.live.live_cc

    def recorded(session, t, **kw):
        order.append(t)
        return live_cc(session, t, **kw)

    server.live.live_cc = recorded
    return order


def direct(server, ts, path) -> list:
    """A fresh session of ``server``'s engine told ``ts`` in turn: every
    ``[[t0, t1], text]``, then the QUESTIONS' answers."""
    session = server.live.open(path)
    out = [[list(span), text] for t in ts for span, text in
           server.live.live_cc(session, t, query=QUERY)]
    return out, [server.live.video_qa(session, q) for q in QUESTIONS]


def test_http_over_a_video_loader_is_a_direct_live_cc_run(npy_clip):
    path, loader = npy_clip
    server = app.DemoServer(path, None, QUERY, device="cpu", video_loader=loader)
    order = admitted(server)
    with serving(server, app.make_handler) as url:
        assert get(url + "/video") == open(path, "rb").read()
        ticks = [json.loads(get(f"{url}/tick?t={t}")) for t in TICKS]
        answers = [post(url + "/qa", q) for q in QUESTIONS]
    assert order == list(TICKS)
    want, want_answers = direct(server, TICKS, path)
    assert [b for tick in ticks for b in tick] == want and answers == want_answers
    assert [span for span, _ in want][:2] == [[0.0, 3.0], [3.0, 4.0]] and len(want) >= 5


def test_ticks_from_threads_serialize(npy_clip):
    """Ticks fired from 4 threads at once (thread switches forced often):
    each answer is what a sequential run in the lock's order gives that
    tick, so their union is the sequential run's; no tick ran outside the
    engine's no-grad entry points."""
    path, loader = npy_clip
    server = app.DemoServer(path, None, QUERY, device="cpu", video_loader=loader)
    order = admitted(server)
    ts = (3.0, 5.0, 6.5, 8.0)
    barrier, bodies = threading.Barrier(len(ts)), {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with serving(server, app.make_handler) as url:
            def fire(t):
                barrier.wait(timeout=60)
                bodies[t] = json.loads(get(f"{url}/tick?t={t}"))

            threads = [threading.Thread(target=fire, args=(t,)) for t in ts]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=300)
            assert not any(thread.is_alive() for thread in threads)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(order) == sorted(ts) and sorted(bodies) == sorted(ts)
    got = [b for t in order for b in bodies[t]]
    want, _ = direct(server, tuple(order), path)
    assert got == want and len(want) >= 4
    assert sorted(s for s, _ in got) == [s for s, _ in got]
    cache = server.session.stream.cache
    assert cache.k.grad_fn is None and not cache.k.requires_grad


def test_unknown_paths_get_404(npy_clip):
    path, loader = npy_clip
    server = app.DemoServer(path, None, QUERY, device="cpu", video_loader=loader)
    with serving(server, app.make_handler) as url:
        for req in (url + "/nope", urllib.request.Request(url + "/tick/x"),
                    urllib.request.Request(url + "/nope", data=b"q", method="POST")):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=60)
            assert err.value.code == 404
        assert get(url + "/").decode() == app.PAGE


def test_cuda_without_a_card_raises(npy_clip, monkeypatch):
    """The server and ``main`` default to cuda and raise naming --device cpu."""
    path, loader = npy_clip
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="demo.app.*--device cpu"):
        app.DemoServer(path, None, QUERY, video_loader=loader)
    with pytest.raises(RuntimeError, match="demo.app.*--device cpu"):
        app.main(["--video", path])


# --- device_preprocess -------------------------------------------------------------

@pytest.mark.parametrize("t,hw,out_hw", [(2, (112, 140), (56, 84)),      # downscale
                                         (2, (20, 30), (56, 84)),        # upscale
                                         (4, (90, 50), (84, 28))])       # non-square
def test_device_preprocess_matches_jax(t, hw, out_hw):
    frames = np.random.RandomState(t + hw[0]).randint(0, 256, (t, *hw, 3), dtype=np.uint8)
    got = device_preprocess(torch.from_numpy(frames), out_h=out_hw[0], out_w=out_hw[1])
    want = np.asarray(jax_device_preprocess(jnp.asarray(frames), out_h=out_hw[0],
                                            out_w=out_hw[1]))
    assert got.dtype == torch.float32 and got.shape == want.shape == (
        t // 2 * out_hw[0] // 14 * out_hw[1] // 14, 3 * 2 * 14 * 14)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_device_preprocess_refuses_an_odd_t():
    with pytest.raises(ValueError, match="temporal_patch_size"):
        device_preprocess(torch.zeros((3, 28, 28, 3), dtype=torch.uint8), out_h=28, out_w=28)

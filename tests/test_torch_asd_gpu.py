"""The active-speaker filter on the card against the CPU.

Marked ``gpu``: each test skips (inside the ``cuda`` fixture) where
``torch.cuda.is_available()`` is false. On a machine with the card:

    python -m pytest --noconftest -m gpu tests/test_torch_asd_gpu.py -q

fp32 with TF32 off. The ONNX executor (``onnx_torch``) on the seeded
test graph (``tools/scrfd_synth.py``) and ``make_detector``'s SCRFD give the CPU's raw
outputs within ``RAW_TOL`` and its boxes after threshold and NMS (frames
with a CPU score within ``RAW_TOL`` of the threshold are skipped);
``lightasd_scores`` gives the CPU's logits within ``LOGIT_TOL``; one
``talking_ratio`` over a still clip gives the CPU's tracks and ratio.
No kernel is written for this path: convs, pools and the GRU are
PyTorch's (cuDNN) on the card.
"""

import numpy as np
import pytest
import torch

from livecc_tpu_torch.tools import asd, lightasd, onnx_lite, onnx_torch, scrfd, scrfd_synth

pytestmark = pytest.mark.gpu
RAW_TOL = 1e-4      # |card - CPU| <= RAW_TOL (1 + |CPU|), detector outputs
LOGIT_TOL = 1e-3    # Light-ASD logits, max abs
HW = (160, 288)     # the reference's decode size, H x W


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_asd_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def frames_of(n, seed=0, still=False):
    r = np.random.RandomState(seed)
    frames = r.randint(0, 256, (n,) + HW + (3,)).astype(np.uint8)
    if still:
        frames[1:] = np.clip(frames[0].astype(int) + r.randint(0, 3, frames[1:].shape), 0,
                             255).astype(np.uint8)
    return frames


def assert_raw_close(got, want):
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.numpy()
        assert g.shape == w.shape
        assert np.all(np.abs(g - w) <= RAW_TOL * (1 + np.abs(w))), np.abs(g - w).max()


def same_boxes(det_gpu, det_cpu, frames, scores_of, threshold):
    checked = 0
    for f in frames:
        if np.any(np.abs(scores_of(f) - threshold) <= RAW_TOL):
            continue
        (gb, gs), (cb, cs) = det_gpu(f), det_cpu(f)
        assert len(gb) == len(cb)
        # scores that tie within RAW_TOL may leave NMS in either order
        gi, ci = (np.lexsort(np.round(b, 2).T) for b in (gb, cb))
        gb, gs, cb, cs = gb[gi], gs[gi], cb[ci], cs[ci]
        np.testing.assert_allclose(gb, cb, rtol=0, atol=1e-3)
        np.testing.assert_allclose(gs, cs, rtol=0, atol=RAW_TOL)
        checked += 1
    assert checked >= len(frames) // 2


def test_onnx_detector_on_the_card_matches_the_cpu(cuda, tmp_path):
    model = scrfd_synth.synth_scrfd_onnx(ch=16, seed=1, score_bias=-0.2, bbox_bias=2.0)
    path = str(tmp_path / "det.onnx")
    onnx_lite.save_model(path, model)
    fns = {d: onnx_torch.build_fn(onnx_lite.load_model(path), d) for d in ("cuda", "cpu")}
    frames = frames_of(4)

    def inputs(f, d):
        return torch.from_numpy(((f.astype(np.float32) - 127.5) / 128.0)
                                .transpose(2, 0, 1)[None].copy()).to(d)

    with torch.inference_mode():
        for f in frames:
            assert_raw_close(fns["cuda"](inputs(f, cuda)), fns["cpu"](inputs(f, "cpu")))
    cfg = scrfd.ScrfdConfig(score_threshold=0.3)

    def scores(f):
        with torch.inference_mode():
            return np.concatenate([o.numpy().ravel() for o in fns["cpu"](inputs(f, "cpu"))[:3]])

    same_boxes(scrfd.load_onnx_detector(path, cfg), scrfd.load_onnx_detector(path, cfg, "cpu"),
               frames, scores, cfg.score_threshold)


def test_make_detector_on_the_card_matches_the_cpu(cuda):
    cfg = scrfd.ScrfdConfig(score_threshold=0.6)
    params = scrfd.init_scrfd_params(cfg, torch.Generator().manual_seed(0))
    mods = {d: scrfd.Scrfd(params, cfg).to(d) for d in ("cuda", "cpu")}
    frames = frames_of(4, seed=1)
    with torch.inference_mode():
        for f in frames:
            got = mods["cuda"](torch.from_numpy(f).to(cuda)[None])
            want = mods["cpu"](torch.from_numpy(f)[None])
            assert_raw_close([t for lvl in got for t in lvl], [t for lvl in want for t in lvl])

    def scores(f):
        with torch.inference_mode():
            return np.concatenate([s.numpy().ravel()
                                   for s, _ in mods["cpu"](torch.from_numpy(f)[None])])

    same_boxes(scrfd.make_detector(params, cfg), scrfd.make_detector(params, cfg, "cpu"),
               frames, scores, cfg.score_threshold)


def test_lightasd_scores_on_the_card_match_the_cpu(cuda):
    state = lightasd.init_lightasd_params(torch.Generator().manual_seed(0))
    r = np.random.RandomState(2)
    faces = r.randint(0, 256, (2, 24, 112, 112)).astype(np.float32)
    mfcc = r.randn(2, 96, 13).astype(np.float32) * 10
    want = lightasd.lightasd_scores(lightasd.make_lightasd(state, "cpu"), faces, mfcc).numpy()
    net = lightasd.make_lightasd(state)
    got = lightasd.lightasd_scores(net, faces, mfcc)
    assert got.device.type == "cuda" and got.shape == (2, 24)
    assert np.abs(got.cpu().numpy() - want).max() <= LOGIT_TOL
    assert lightasd.track_score(net, faces[0], mfcc[0]) == pytest.approx(
        float(torch.sigmoid(torch.from_numpy(want[0])).mean()), abs=LOGIT_TOL)


def test_talking_ratio_on_the_card_matches_the_cpu(cuda):
    cfg = scrfd.ScrfdConfig(score_threshold=0.9)
    params = scrfd.init_scrfd_params(cfg, torch.Generator().manual_seed(0))
    params["head"]["bbox"]["bias"] = torch.full((8,), 2.0)       # boxes of positive extent
    state = lightasd.init_lightasd_params(torch.Generator().manual_seed(1))
    frames = frames_of(30, seed=3, still=True)
    feats = asd.mfcc(np.sin(np.linspace(0, 900, 30 * 640)).astype(np.float32))
    results = {}
    for d in ("cuda", "cpu"):
        net, tracks = lightasd.make_lightasd(state, d), []

        def score_track(track, fr, net=net, tracks=tracks):
            tracks.append((list(track.frames), np.stack(track.boxes)))
            faces = np.stack([fr[i, :112, :112].mean(-1) for i in track.frames])
            lo = 4 * track.frames[0]
            return lightasd.track_score(net, faces.astype(np.float32),
                                        feats[lo:lo + 4 * len(faces)])

        ratio = asd.talking_ratio(frames, scrfd.make_detector(params, cfg, d), score_track,
                                  window=10, stride=15, min_track_len=5)
        results[d] = (ratio, tracks)
    (ratio, tracks), (ratio_cpu, tracks_cpu) = results["cuda"], results["cpu"]
    assert ratio == ratio_cpu and len(tracks) == len(tracks_cpu) > 0
    for (f, b), (g, c) in zip(tracks, tracks_cpu):
        assert f == g
        np.testing.assert_allclose(b, c, rtol=0, atol=1e-3)

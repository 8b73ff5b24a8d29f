"""The active-speaker filter's port (``livecc_tpu_torch/tools/{onnx_lite,asd,
onnx_torch,scrfd,lightasd}.py``, ``ops/resize.py``) against the JAX package.

Inputs come from numpy seeds and go through both packages on the CPU. The
host code (the ONNX wire format, boxes, NMS, tracks, windows, MFCCs, the
talking ratio) must be equal; the float paths (``jax.image.resize``, the
ONNX executor, SCRFD, Light-ASD) agree within rtol = atol = 1e-5.
"""

import numpy as np
import pytest
import torch

import jax

from livecc_tpu.tools import asd as j_asd
from livecc_tpu.tools import lightasd as j_lightasd
from livecc_tpu.tools import onnx_lite as j_ox
from livecc_tpu.tools import scrfd as j_scrfd
from livecc_tpu.tools.onnx_jax import build_fn as j_build_fn
from livecc_tpu_torch.ops.resize import resize
from livecc_tpu_torch.tools import asd, lightasd, onnx_lite, scrfd, scrfd_synth
from livecc_tpu_torch.tools.onnx_lite import Model, Node
from livecc_tpu_torch.tools.onnx_torch import build_fn
from test_onnx_import import synth_scrfd_onnx
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------- onnx_lite

def all_attrs_model():
    r = np.random.RandomState(3)
    attrs = [onnx_lite.attr_i("i", -3), onnx_lite.attr_f("f", 0.25), onnx_lite.attr_s("s", "x"),
             onnx_lite.attr_ints("ints", (1, -2, 3)), onnx_lite.attr_floats("fl", (0.5, -1.5)),
             onnx_lite.Attribute(name="t", type=onnx_lite.AT_TENSOR,
                                 t=r.randn(2, 3).astype(np.float32))]
    inits = {"w": r.randn(4, 3, 3, 3).astype(np.float32),
             "i64": np.asarray([-1, 4], np.int64), "i32": np.asarray([7, -8], np.int32),
             "u8": np.arange(5, dtype=np.uint8), "f64": r.randn(3),
             "b": np.asarray([True, False])}
    return Model(nodes=[Node(op_type="Conv", inputs=["x", "w"], outputs=["y"], name="c",
                             attrs={a.name: a for a in attrs}),
                        Node(op_type="Relu", inputs=["y"], outputs=["z"])],
                 initializers=inits, inputs=["x"], outputs=["z"], name="attrs")


def test_onnx_lite_save_model_bytes_equal_jax(tmp_path):
    j_model = synth_scrfd_onnx(str(tmp_path / "j.onnx"), ch=8)
    port = scrfd_synth.synth_scrfd_onnx(ch=8)
    onnx_lite.save_model(str(tmp_path / "p.onnx"), port)
    assert (tmp_path / "p.onnx").read_bytes() == (tmp_path / "j.onnx").read_bytes()
    # the same Model object through both writers, every attribute and dtype
    model = all_attrs_model()
    onnx_lite.save_model(str(tmp_path / "a.onnx"), model)
    j_ox.save_model(str(tmp_path / "b.onnx"), model)
    assert (tmp_path / "a.onnx").read_bytes() == (tmp_path / "b.onnx").read_bytes()
    assert len(j_model.nodes) == len(port.nodes)


@pytest.mark.parametrize("which", ["scrfd", "attrs"])
def test_onnx_lite_load_model_equals_jax(tmp_path, which):
    path = str(tmp_path / "m.onnx")
    if which == "scrfd":
        synth_scrfd_onnx(path, ch=4)
    else:
        j_ox.save_model(path, all_attrs_model())
    a, b = onnx_lite.load_model(path), j_ox.load_model(path)
    assert (a.inputs, a.outputs, a.name) == (b.inputs, b.outputs, b.name)
    assert len(a.nodes) == len(b.nodes)
    for x, y in zip(a.nodes, b.nodes):
        assert (x.op_type, x.inputs, x.outputs, x.name) == (y.op_type, y.inputs, y.outputs,
                                                            y.name)
        assert x.attrs.keys() == y.attrs.keys()
        for k in x.attrs:
            vx, vy = x.attr(k), y.attr(k)
            if isinstance(vx, np.ndarray):
                np.testing.assert_array_equal(vx, vy)
            else:
                assert vx == vy
    assert a.initializers.keys() == b.initializers.keys()
    for k in a.initializers:
        assert a.initializers[k].dtype == b.initializers[k].dtype
        np.testing.assert_array_equal(a.initializers[k], b.initializers[k])


def test_onnx_lite_packed_int32_negative_values():
    vals = [-2, -1, 0, 1, 127, -(2**31)]
    body = bytearray()
    onnx_lite._emit(body, 1, 0, len(vals))
    onnx_lite._emit(body, 2, 0, onnx_lite.DT_INT32)
    packed = bytearray()
    for v in vals:
        onnx_lite._write_varint(packed, v & ((1 << 64) - 1))
    onnx_lite._emit(body, 5, 2, bytes(packed))
    onnx_lite._emit(body, 8, 2, b"t")
    name, arr = onnx_lite._decode_tensor(bytes(body))
    j_name, j_arr = j_ox._decode_tensor(bytes(body))
    assert name == j_name == "t" and arr.dtype == j_arr.dtype == np.int32
    np.testing.assert_array_equal(arr, np.asarray(vals, np.int32))
    np.testing.assert_array_equal(arr, j_arr)


# ---------------------------------------------------------------- asd (host)

def random_boxes(r, n, size=60.0):
    xy = r.rand(n, 2) * size
    wh = r.rand(n, 2) * 20 + 2
    return np.concatenate([xy, xy + wh], axis=1)


def test_asd_boxes_nms_windows_mfcc_equal_jax():
    r = np.random.RandomState(0)
    a, b = random_boxes(r, 7), random_boxes(r, 9)
    b[0] = b[0, [2, 3, 0, 1]]                      # a degenerate (inverted) box
    np.testing.assert_array_equal(asd.box_iou(a, b), j_asd.box_iou(a, b))
    boxes = random_boxes(r, 40, 30.0)
    scores = r.rand(40)
    for thr in (0.1, 0.4, 0.7):
        np.testing.assert_array_equal(asd.nms(boxes, scores, thr), j_asd.nms(boxes, scores, thr))
    for n, w, s in ((0, 150, 750), (149, 150, 750), (7500, 150, 750), (2000, 100, 150)):
        assert asd.window_indices(n, w, s) == j_asd.window_indices(n, w, s)
    assert asd.window_indices(7500) == [(i, i + 150) for i in range(0, 7500, 750)]
    audio = r.randn(16000 * 3).astype(np.float32)
    np.testing.assert_array_equal(asd.mfcc(audio), j_asd.mfcc(audio))
    np.testing.assert_array_equal(asd.mfcc(audio[:300]), j_asd.mfcc(audio[:300]))
    for ratio in (0.0, 0.05, 0.051, 1.0):
        assert asd.keep_clip(ratio) == j_asd.keep_clip(ratio)


def tracks_of(tracker):
    return [(t.track_id, list(t.frames), np.stack(t.boxes)) for t in tracker.tracks]


def test_face_tracker_tracks_equal_jax():
    r = np.random.RandomState(1)
    faces = random_boxes(r, 4)
    port, ref = asd.FaceTracker(), j_asd.FaceTracker()
    for i in range(60):
        drift = faces + r.randn(*faces.shape) * 1.5 + i * 0.3
        shown = drift[r.rand(len(drift)) > 0.2]            # faces drop out and come back
        if i % 13 == 0:
            shown = np.concatenate([shown, random_boxes(r, 2)])    # spurious boxes
        if i in range(25, 40):
            shown = shown[:0]                                  # a gap past max_gap
        port.update(i, shown)
        ref.update(i, shown)
    got, want = tracks_of(port), tracks_of(ref)
    assert len(got) == len(want) > 4
    for (i, f, b), (j, g, c) in zip(got, want):
        assert i == j and f == g
        np.testing.assert_array_equal(b, c)


# ---------------------------------------------------------------- ops/resize

@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("src,dst", [((5, 9), (7, 13)), ((5, 9), (3, 4)), ((8, 8), (16, 16)),
                                     ((16, 12), (8, 6)), ((7, 11), (21, 33)),
                                     ((20, 36), (10, 18)), ((9, 9), (5, 13))])
def test_resize_equals_jax_image_resize(method, src, dst):
    x = np.random.RandomState(2).randn(2, 3, *src).astype(np.float32)
    got = resize(torch.from_numpy(x), (2, 3) + dst, method).numpy()
    want = np.asarray(jax.image.resize(x, (2, 3) + dst, method))
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        close(got, want)


def test_resize_every_changed_axis_as_jax():
    """JAX resizes batch and channel axes too when their sizes change."""
    x = np.random.RandomState(3).randn(1, 4, 6, 10).astype(np.float32)
    for method in ("nearest", "linear", "cubic"):
        close(resize(torch.from_numpy(x), (2, 7, 9, 5), method).numpy(),
              jax.image.resize(x, (2, 7, 9, 5), method))


# ---------------------------------------------------------------- onnx_torch

def single(op, inputs, attrs=(), inits=None, n_outputs=1):
    inits = dict(inits or {})
    names = [f"in{i}" if v is not None else "" for i, v in enumerate(inputs)]
    node = Node(op_type=op, inputs=names + list(inits),
                outputs=[f"out{i}" for i in range(n_outputs)],
                attrs={a.name: a for a in attrs})
    return Model(nodes=[node], initializers=inits, inputs=[n for n in names if n],
                 outputs=[f"out{i}" for i in range(n_outputs)])


def run_both(model, inputs):
    inputs = [x for x in inputs if x is not None]
    got = build_fn(model, "cpu")(*[torch.from_numpy(x) for x in inputs])
    want = j_build_fn(model)(*inputs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == np.shape(w)
        close(g, w)


def ox_ints(name, v):
    return onnx_lite.attr_ints(name, v)


def rn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


CONV_CASES = {
    "explicit_pads": [ox_ints("pads", (1, 2, 0, 1)), ox_ints("strides", (2, 1))],
    "same_upper_s2_even": [onnx_lite.attr_s("auto_pad", "SAME_UPPER"), ox_ints("strides", (2, 2))],
    "same_lower_s2_odd": [onnx_lite.attr_s("auto_pad", "SAME_LOWER"), ox_ints("strides", (2, 2))],
    "dilation_same": [onnx_lite.attr_s("auto_pad", "SAME_UPPER"), ox_ints("dilations", (2, 3))],
    "dilation_pads": [ox_ints("pads", (2, 2, 2, 2)), ox_ints("dilations", (2, 2))],
    "groups": [onnx_lite.attr_i("group", 2), ox_ints("pads", (1, 1, 1, 1))],
    "depthwise_s2": [onnx_lite.attr_i("group", 4), onnx_lite.attr_s("auto_pad", "SAME_UPPER"),
                     ox_ints("strides", (2, 2))],
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_onnx_conv_equals_jax(case):
    attrs = CONV_CASES[case]
    group = next((a.i for a in attrs if a.name == "group"), 1)
    hw = (15, 17) if case == "same_lower_s2_odd" else (16, 20)
    x = rn(2, 4, *hw)
    w = rn(6 if group != 4 else 4, 4 // group, 3, 3, seed=1)
    run_both(single("Conv", [x], attrs, {"w": w, "b": rn(w.shape[0], seed=2)}), [x])
    run_both(single("Conv", [x], attrs, {"w": w}), [x])


POOL_CASES = {
    "max_same_s2": ("MaxPool", [ox_ints("kernel_shape", (3, 3)), ox_ints("strides", (2, 2)),
                                onnx_lite.attr_s("auto_pad", "SAME_UPPER")]),
    "max_pads": ("MaxPool", [ox_ints("kernel_shape", (3, 2)), ox_ints("strides", (2, 1)),
                             ox_ints("pads", (1, 0, 1, 1))]),
    "avg_same_s2": ("AveragePool", [ox_ints("kernel_shape", (3, 3)), ox_ints("strides", (2, 2)),
                                    onnx_lite.attr_s("auto_pad", "SAME_LOWER")]),
    "avg_pads": ("AveragePool", [ox_ints("kernel_shape", (3, 3)), ox_ints("strides", (1, 2)),
                                 ox_ints("pads", (1, 1, 1, 1))]),
    "avg_none": ("AveragePool", [ox_ints("kernel_shape", (2, 2)), ox_ints("strides", (2, 2))]),
    "global_avg": ("GlobalAveragePool", []),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_onnx_pool_equals_jax(case):
    op, attrs = POOL_CASES[case]
    for hw in ((12, 14), (11, 13)):
        x = rn(2, 3, *hw, seed=4)
        run_both(single(op, [x], attrs), [x])


@pytest.mark.parametrize("mode", ["nearest", "linear", "cubic"])
def test_onnx_resize_and_upsample_equal_jax(mode):
    x = rn(1, 3, 6, 10, seed=5)
    attrs = [onnx_lite.attr_s("mode", mode), onnx_lite.attr_f("cubic_coeff_a", -0.75)]
    for scales in ((1, 1, 2, 2), (1, 1, 0.5, 0.5), (1, 1, 1.5, 0.7)):
        run_both(single("Resize", [x, None], attrs,
                        {"scales": np.asarray(scales, np.float32)}), [x])
    sizes = {"roi": np.zeros(0, np.float32), "scales": np.zeros(0, np.float32),
             "sizes": np.asarray([1, 3, 9, 7], np.int64)}
    run_both(single("Resize", [x], attrs, sizes), [x])
    run_both(single("Upsample", [x], attrs, {"scales": np.asarray([1, 1, 2, 3], np.float32)}),
             [x])


def test_onnx_elementwise_and_layout_ops_equal_jax():
    a, b = rn(2, 3, 4, 5, seed=6), rn(2, 3, 4, 5, seed=7)
    stats = {"s": np.abs(rn(3, seed=8)) + 0.5, "bb": rn(3, seed=9), "m": rn(3, seed=10),
             "v": np.abs(rn(3, seed=11)) + 0.1}
    run_both(single("BatchNormalization", [a], [onnx_lite.attr_f("epsilon", 1e-3)], stats), [a])
    for op in ("Relu", "Sigmoid", "Exp", "Identity"):
        run_both(single(op, [a]), [a])
    run_both(single("LeakyRelu", [a], [onnx_lite.attr_f("alpha", 0.2)]), [a])
    run_both(single("PRelu", [a], inits={"slope": rn(3, seed=12)}), [a])
    run_both(single("Softmax", [a], [onnx_lite.attr_i("axis", 1)]), [a])
    run_both(single("Clip", [a], inits={"lo": np.float32(-0.5), "hi": np.float32(0.7)}), [a])
    run_both(single("Clip", [a], [onnx_lite.attr_f("min", -0.1), onnx_lite.attr_f("max", 0.2)]),
             [a])
    for op in ("Add", "Sub", "Mul", "Div"):
        run_both(single(op, [a, b]), [a, b])
        run_both(single(op, [a], inits={"c": rn(1, 3, 1, 1, seed=13)}), [a])
    run_both(single("Concat", [a, b], [onnx_lite.attr_i("axis", 1)]), [a, b])
    run_both(single("Transpose", [a], [ox_ints("perm", (0, 2, 3, 1))]), [a])
    run_both(single("Transpose", [a]), [a])
    run_both(single("Flatten", [a], [onnx_lite.attr_i("axis", 2)]), [a])
    run_both(single("Reshape", [a], inits={"shape": np.asarray([2, -1, 5], np.int64)}), [a])
    run_both(single("Squeeze", [a[:, :1]], [ox_ints("axes", (1,))]), [a[:, :1]])
    run_both(single("Slice", [a], inits={"st": np.asarray([1, 0], np.int64),
                                         "en": np.asarray([3, 2**31 - 1], np.int64),
                                         "ax": np.asarray([2, 3], np.int64)}), [a])
    m, n = rn(3, 4, seed=14), rn(5, 4, seed=15)
    run_both(single("Gemm", [m], [onnx_lite.attr_i("transB", 1), onnx_lite.attr_f("alpha", 0.5),
                                  onnx_lite.attr_f("beta", 2.0)],
                    {"w": n, "c": rn(5, seed=16)}), [m])
    run_both(single("MatMul", [m], inits={"w": n.T.copy()}), [m])


def test_onnx_shape_chain_folds_on_the_host():
    """Shape -> Gather -> Unsqueeze -> Concat -> Reshape, and Constant: the
    chain stays numpy, so Reshape reads no device tensor."""
    x = rn(2, 3, 4, 5, seed=17)
    const = onnx_lite.Attribute(name="value", type=onnx_lite.AT_TENSOR,
                                t=np.asarray([-1], np.int64))
    nodes = [Node(op_type="Shape", inputs=["x"], outputs=["shp"]),
             Node(op_type="Gather", inputs=["shp", "zero"], outputs=["n"],
                  attrs={"axis": onnx_lite.attr_i("axis", 0)}),
             Node(op_type="Unsqueeze", inputs=["n"], outputs=["n1"],
                  attrs={"axes": ox_ints("axes", (0,))}),
             Node(op_type="Constant", inputs=[], outputs=["m1"], attrs={"value": const}),
             Node(op_type="Concat", inputs=["n1", "m1"], outputs=["tgt"],
                  attrs={"axis": onnx_lite.attr_i("axis", 0)}),
             Node(op_type="Reshape", inputs=["x", "tgt"], outputs=["y"]),
             Node(op_type="Gather", inputs=["y", "idx"], outputs=["z"],
                  attrs={"axis": onnx_lite.attr_i("axis", 1)})]
    model = Model(nodes=nodes, initializers={"zero": np.asarray(0, np.int64),
                                             "idx": np.asarray([[0, 5], [-1, 2]], np.int64)},
                  inputs=["x"], outputs=["y", "z", "tgt"])
    run_both(model, [x])
    got = build_fn(model, "cpu")(torch.from_numpy(x))
    assert isinstance(got[2], np.ndarray) and got[2].tolist() == [2, -1]


def test_onnx_scrfd_graph_through_both_detectors(tmp_path):
    path = str(tmp_path / "det.onnx")
    synth_scrfd_onnx(path)
    frame = np.random.RandomState(0).randint(0, 255, (160, 288, 3), np.uint8)
    for thr in (0.0, 0.13):
        got = scrfd.load_onnx_detector(path, scrfd.ScrfdConfig(score_threshold=thr), "cpu")(frame)
        want = j_scrfd.load_onnx_detector(path, j_scrfd.ScrfdConfig(score_threshold=thr))(frame)
        assert len(got[0]) == len(want[0]) > 0
        if thr == 0.0:
            # ~1900 boxes: scores that tie within 1e-6 may leave NMS in either order
            order = [np.lexsort(np.round(b, 3).T) for b in (got[0], want[0])]
            got = [x[order[0]] for x in got]
            want = [x[order[1]] for x in want]
        close(got[0], want[0])
        close(got[1], want[1])
    # the raw outputs, in the reference's order
    x = ((frame.astype(np.float32) - 127.5) / 128.0).transpose(2, 0, 1)[None].copy()
    run_both(onnx_lite.load_model(path), [x])


# ---------------------------------------------------------------- scrfd

def scrfd_pair(cfg=None, seed=0):
    cfg = cfg or j_scrfd.ScrfdConfig()
    jp = j_scrfd.init_scrfd_params(cfg, jax.random.PRNGKey(seed))
    return cfg, jp, scrfd.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


@pytest.mark.parametrize("hw", [(64, 96), (70, 101)])
def test_scrfd_forward_equals_jax(hw):
    cfg, jp, tp = scrfd_pair()
    frames = np.random.RandomState(1).randint(0, 255, (2,) + hw + (3,), np.uint8)
    got = scrfd.Scrfd(tp, scrfd.ScrfdConfig())(torch.from_numpy(frames))
    want = jax.jit(lambda p, f: j_scrfd.scrfd_forward(p, cfg, f))(jp, frames)
    for (gs, gb), (ws, wb), stride in zip(got, want, cfg.strides):
        n = -(-hw[0] // stride) * -(-hw[1] // stride) * cfg.num_anchors
        assert gs.shape == (2, n) and gb.shape == (2, n, 4)
        close(gs.numpy(), ws)
        close(gb.numpy(), wb)
    assert tp["stages"][0]["dw"]["kernel"].shape == (16, 1, 3, 3)     # depthwise, groups=C


def test_scrfd_decode_and_detector_equal_jax():
    r = np.random.RandomState(2)
    cfg = scrfd.ScrfdConfig(score_threshold=0.3)
    h, w = 70, 101
    levels = [(r.rand(n).astype(np.float32), r.randn(n, 4).astype(np.float32) * 2)
              for n in (-(-h // s) * -(-w // s) * 2 for s in cfg.strides)]
    got = scrfd.decode_detections(cfg, levels, h, w)
    want = j_scrfd.decode_detections(j_scrfd.ScrfdConfig(score_threshold=0.3), levels, h, w)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    for s in cfg.strides:
        np.testing.assert_array_equal(scrfd.anchor_centers(h, w, s, 2),
                                      j_scrfd.anchor_centers(h, w, s, 2))
    jcfg, jp, tp = scrfd_pair(j_scrfd.ScrfdConfig(score_threshold=0.2), seed=3)
    frame = r.randint(0, 255, (64, 96, 3), np.uint8)
    got = scrfd.make_detector(tp, scrfd.ScrfdConfig(score_threshold=0.2), "cpu")(frame)
    want = j_scrfd.make_detector(jp, jcfg)(frame)
    assert len(got[0]) == len(want[0]) > 0
    close(got[0], want[0])
    close(got[1], want[1])


@pytest.mark.parametrize("which", ["make_detector", "load_onnx_detector"])
def test_detect_faces_is_its_levels_then_decode(tmp_path, which):
    """``detect_faces.levels`` (the device part) then ``decode_detections``
    (the host part) is ``detect_faces``, which lets a caller time them apart."""
    cfg = scrfd.ScrfdConfig(score_threshold=0.3)
    if which == "make_detector":
        det = scrfd.make_detector(scrfd_pair(seed=3)[2], cfg, "cpu")
    else:
        path = str(tmp_path / "det.onnx")
        onnx_lite.save_model(path, scrfd_synth.synth_scrfd_onnx(score_bias=0.0))
        det = scrfd.load_onnx_detector(path, cfg, "cpu")
    frame = np.random.RandomState(4).randint(0, 255, (64, 96, 3), np.uint8)
    boxes, scores = det(frame)
    parts = scrfd.decode_detections(cfg, det.levels(frame), 64, 96)
    assert len(boxes) > 0
    np.testing.assert_array_equal(parts[0], boxes)
    np.testing.assert_array_equal(parts[1], scores)


@pytest.mark.parametrize("name,group", [
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize32x32x8_stage3", "conv"),
    ("void at::native::conv_depthwise2d_forward_kernel<0, float, int>(...)", "conv"),
    ("void cudnn::rnn::GRU_elementWise_fp<float, float, float>(...)", "GRU"),
    ("Memcpy HtoD (Pageable -> Device)", "copies"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nchw<float>(...)", "pooling"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::launch_clamp_scalar>(...)",
     "elementwise"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 8>(...)", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>(...)", "elementwise"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1", "matmul"),
    ("nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NTN", "matmul"),
    ("void convert_scales_kernel(float const*)", "other"),
])
def test_profile_groups_the_asd_kernels(name, group):
    from livecc_tpu_torch.tools.profile_stream import _group

    assert _group(name) == group


def test_scrfd_npz_cross_loads(tmp_path):
    cfg, jp, tp = scrfd_pair(seed=4)
    j_scrfd.save_npz(str(tmp_path / "j.npz"), jp)
    loaded = scrfd.load_npz(str(tmp_path / "j.npz"), scrfd.ScrfdConfig())
    port = scrfd.init_scrfd_params(scrfd.ScrfdConfig(), torch.Generator().manual_seed(5))
    scrfd.save_npz(str(tmp_path / "p.npz"), port)
    back = j_scrfd.load_npz(str(tmp_path / "p.npz"), cfg)
    for (ka, a), (kb, b) in zip(scrfd._iter_leaves(loaded), scrfd._iter_leaves(tp)):
        assert ka == kb
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for (ka, a), (kb, b) in zip(j_scrfd._iter_leaves(back), scrfd._iter_leaves(port)):
        assert ka == kb
        np.testing.assert_array_equal(scrfd.params_from_jax(np.asarray(a)).numpy(), b.numpy())


def test_entry_points_refuse_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = scrfd.ScrfdConfig()
    params = scrfd.init_scrfd_params(cfg, torch.Generator().manual_seed(0))
    path = str(tmp_path / "det.onnx")
    onnx_lite.save_model(path, scrfd_synth.synth_scrfd_onnx())
    state = lightasd.init_lightasd_params(torch.Generator().manual_seed(0))
    for call in (lambda: scrfd.make_detector(params, cfg),
                 lambda: scrfd.load_onnx_detector(path, cfg),
                 lambda: lightasd.make_lightasd(state),
                 lambda: lightasd.load_torch_checkpoint(str(tmp_path / "none.model"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ---------------------------------------------------------------- lightasd

def jax_lightasd_params(seed=1):
    """JAX's Light-ASD params from a seeded reference-layout state dict
    (BatchNorm statistics, GRU and head biases all away from 1 / 0, so
    every term of the forward is checked). JAX's own init draws each leaf
    eagerly and takes ~15 s here."""
    return j_lightasd.convert_torch_state(reference_state_dict(seed))


def test_lightasd_scores_and_track_score_equal_jax():
    jp = jax_lightasd_params()
    model = lightasd.make_lightasd(lightasd.params_from_jax(jp), "cpu")
    r = np.random.RandomState(0)
    b, t = 2, 8
    faces = r.randint(0, 256, (b, t, 112, 112)).astype(np.float32)
    for n_mfcc in (4 * t, 4 * t - 6):               # aligned, and trimmed / zero-padded
        mfcc = r.randn(b, n_mfcc, 13).astype(np.float32) * 10
        close(lightasd.lightasd_scores(model, faces, mfcc).numpy(),
              j_lightasd.lightasd_scores(jp, faces, mfcc))
    mfcc = r.randn(4 * t, 13).astype(np.float32)
    assert lightasd.track_score(model, faces[0], mfcc) == pytest.approx(
        j_lightasd.track_score(jp, faces[0], mfcc), rel=1e-5, abs=1e-5)


def reference_state_dict(seed=2):
    """A seeded state dict in the reference checkpoint's key layout
    (finetuning_TalkSet.model, lightasd.py:110-119 of the JAX package)."""
    r = np.random.RandomState(seed)
    sd = {}

    def conv_bn(prefix, name, shape):
        sd[f"{prefix}.{name}.weight"] = torch.from_numpy(
            (r.randn(*shape) * (2.0 / np.prod(shape[1:])) ** 0.5).astype(np.float32))
        c = shape[0]
        sd[f"{prefix}.bn_{name}.weight"] = torch.from_numpy((1 + r.randn(c) * 0.1).astype(np.float32))
        sd[f"{prefix}.bn_{name}.bias"] = torch.from_numpy((r.randn(c) * 0.1).astype(np.float32))
        sd[f"{prefix}.bn_{name}.running_mean"] = torch.from_numpy(
            (r.randn(c) * 0.1).astype(np.float32))
        sd[f"{prefix}.bn_{name}.running_var"] = torch.from_numpy(
            (r.rand(c) + 0.5).astype(np.float32))
        sd[f"{prefix}.bn_{name}.num_batches_tracked"] = torch.tensor(0)

    for i, (cin, cout) in enumerate(((1, 32), (32, 64), (64, 128)), 1):
        v, a = f"model.visualEncoder.block{i}", f"model.audioEncoder.block{i}"
        for name, k, c in (("s_3", (1, 3, 3), cin), ("t_3", (3, 1, 1), cout),
                           ("s_5", (1, 5, 5), cin), ("t_5", (5, 1, 1), cout),
                           ("last", (1, 1, 1), cout)):
            conv_bn(v, name, (cout, c) + k)
        for name, k, c in (("m_3", (3, 1), cin), ("t_3", (1, 3), cout), ("m_5", (5, 1), cin),
                           ("t_5", (1, 5), cout), ("last", (1, 1), cout)):
            conv_bn(a, name, (cout, c) + k)
    for d in ("forward", "backward"):
        for k, shape in (("weight_ih_l0", (384, 128)), ("weight_hh_l0", (384, 128)),
                         ("bias_ih_l0", (384,)), ("bias_hh_l0", (384,))):
            sd[f"model.GRU.gru_{d}.{k}"] = torch.from_numpy(
                (r.randn(*shape) * 0.1).astype(np.float32))
    sd["lossAV.FC.weight"] = torch.from_numpy((r.randn(2, 128) * 0.1).astype(np.float32))
    sd["lossAV.FC.bias"] = torch.from_numpy((r.randn(2) * 0.1).astype(np.float32))
    sd["lossV.FC.weight"] = torch.zeros(2, 128)                      # unused, as the reference
    return sd


def test_lightasd_convert_torch_state_equals_jax(tmp_path):
    sd = reference_state_dict()
    jp = j_lightasd.convert_torch_state(sd)
    path = str(tmp_path / "ref.model")
    torch.save(sd, path)
    model = lightasd.load_torch_checkpoint(path, "cpu")
    r = np.random.RandomState(3)
    faces = r.randint(0, 256, (1, 8, 112, 112)).astype(np.float32)
    mfcc = r.randn(1, 32, 13).astype(np.float32) * 10
    close(lightasd.lightasd_scores(model, faces, mfcc).numpy(),
          j_lightasd.lightasd_scores(jp, faces, mfcc))
    # the conversion is the JAX params' layout, moved: params_from_jax agrees
    via_jax = lightasd.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    for k, v in lightasd.convert_torch_state(sd).items():
        np.testing.assert_array_equal(v.numpy(), via_jax[k].numpy())


# ---------------------------------------------------------------- the chain

def tube_builder(score, feats):
    """``score_track`` for ``talking_ratio``: the track's grayscale 112x112
    face tube (0..255, as lightasd.py:227-229 asks) and its MFCC rows;
    records each track it scores."""
    seen = []

    def score_track(track, frames):
        tube = []
        h_f, w_f = frames.shape[1], frames.shape[2]
        for fi, box in zip(track.frames, track.boxes):
            x1, y1, x2, y2 = [int(v) for v in box]
            x1 = min(max(x1, 0), w_f - 1)
            y1 = min(max(y1, 0), h_f - 1)
            x2 = min(max(x2, x1 + 1), w_f)
            y2 = min(max(y2, y1 + 1), h_f)
            crop = frames[fi, y1:y2, x1:x2].mean(axis=-1)
            yy = np.linspace(0, crop.shape[0] - 1, 112).astype(int)
            xx = np.linspace(0, crop.shape[1] - 1, 112).astype(int)
            tube.append(crop[np.ix_(yy, xx)])
        faces = np.stack(tube).astype(np.float32)
        lo = 4 * track.frames[0]
        seen.append((list(track.frames), np.stack(track.boxes)))
        return score(faces, feats[lo:lo + 4 * len(faces)])

    return score_track, seen


def test_talking_ratio_chain_equals_jax():
    cfg = j_scrfd.ScrfdConfig(score_threshold=0.9)
    jp = j_scrfd.init_scrfd_params(cfg, jax.random.PRNGKey(0))
    # distances of ~2 strides: boxes of positive extent, which IoU can track
    jp["head"]["bbox"]["bias"] = jax.numpy.full((8,), 2.0)
    tp = scrfd.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    j_asd_params = jax_lightasd_params(seed=5)
    model = lightasd.make_lightasd(lightasd.params_from_jax(j_asd_params), "cpu")
    r = np.random.RandomState(5)
    frames = r.randint(0, 255, (8, 64, 96, 3), np.uint8)
    frames[1:] = frames[0]                       # a still shot: the boxes come back
    feats = asd.mfcc(np.sin(np.linspace(0, 900, 8 * 640)).astype(np.float32))
    port_score, port_seen = tube_builder(lambda f, m: lightasd.track_score(model, f, m), feats)
    ref_score, ref_seen = tube_builder(lambda f, m: j_lightasd.track_score(j_asd_params, f, m),
                                       feats)
    kw = dict(window=4, stride=4, min_track_len=4)
    got = asd.talking_ratio(frames, scrfd.make_detector(tp, scrfd.ScrfdConfig(
        score_threshold=0.9), "cpu"), port_score, **kw)
    want = j_asd.talking_ratio(frames, j_scrfd.make_detector(jp, cfg), ref_score, **kw)
    assert got == want
    assert len(port_seen) == len(ref_seen) > 0
    for (f, b), (g, c) in zip(port_seen, ref_seen):
        assert f == g
        close(b, c)

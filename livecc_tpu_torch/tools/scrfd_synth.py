"""A seeded SCRFD-style ONNX graph, for tests and ``chip_smoke.py``.

``det_500m.onnx`` (buffalo_sc's detector) is not in the repository, so the
tests and the card's smoke run execute a graph of 44 nodes written by the
port's ``onnx_lite``: a stem, stride-8/16/32 Conv+BN+ReLU stages, a top-down FPN
(nearest Resize + Add) and per-stride heads emitting sigmoid scores
[N*A, 1] and bbox distances [N*A, 4] in the reference's output order
(face_detector.py:40-58). It has the detector's output contract, not its
depth: the real graph's depthwise backbone and keypoint outputs are
missing, so a time measured on it is a lower bound for the real graph's.
"""

from __future__ import annotations

import numpy as np

from livecc_tpu_torch.tools import onnx_lite as ox
from livecc_tpu_torch.tools.onnx_lite import Model, Node


def synth_scrfd_onnx(ch: int = 8, num_anchors: int = 2, seed: int = 0,
                     score_bias: float = -2.0, bbox_bias: float = 0.0) -> Model:
    """The seeded graph: at the defaults the JAX package's test graph
    (``tests/test_onnx_import.py:synth_scrfd_onnx``) byte for byte once
    saved; ``score_bias`` / ``bbox_bias`` are the heads' bias values."""
    r = np.random.RandomState(seed)
    init = {}
    nodes = []

    def conv_bn_relu(name, src, cin, cout, stride):
        init[f"{name}_w"] = (r.randn(cout, cin, 3, 3) * (9 * cin) ** -0.5).astype(np.float32)
        init[f"{name}_bn_s"] = np.ones(cout, np.float32)
        init[f"{name}_bn_b"] = np.zeros(cout, np.float32)
        init[f"{name}_bn_m"] = (r.randn(cout) * 0.01).astype(np.float32)
        init[f"{name}_bn_v"] = np.ones(cout, np.float32)
        nodes.append(Node(op_type="Conv", inputs=[src, f"{name}_w"], outputs=[f"{name}_c"],
                          attrs={"pads": ox.attr_ints("pads", (1, 1, 1, 1)),
                                 "strides": ox.attr_ints("strides", (stride, stride))}))
        nodes.append(Node(op_type="BatchNormalization",
                          inputs=[f"{name}_c", f"{name}_bn_s", f"{name}_bn_b",
                                  f"{name}_bn_m", f"{name}_bn_v"],
                          outputs=[f"{name}_bn"]))
        nodes.append(Node(op_type="Relu", inputs=[f"{name}_bn"], outputs=[name]))
        return name

    s = conv_bn_relu("stem", "input.1", 3, ch, 2)
    s = conv_bn_relu("stage4", s, ch, ch, 2)
    c8 = conv_bn_relu("stage8", s, ch, ch * 2, 2)
    c16 = conv_bn_relu("stage16", c8, ch * 2, ch * 4, 2)
    c32 = conv_bn_relu("stage32", c16, ch * 4, ch * 8, 2)

    # FPN laterals + top-down nearest upsample
    for name, src, cin in [("lat8", c8, ch * 2), ("lat16", c16, ch * 4),
                           ("lat32", c32, ch * 8)]:
        init[f"{name}_w"] = (r.randn(ch * 2, cin, 1, 1) * cin ** -0.5).astype(np.float32)
        nodes.append(Node(op_type="Conv", inputs=[src, f"{name}_w"], outputs=[name]))
    init["up_scales"] = np.asarray([1, 1, 2, 2], np.float32)
    nodes.append(Node(op_type="Resize", inputs=["lat32", "", "up_scales"],
                      outputs=["up32"], attrs={"mode": ox.attr_s("mode", "nearest")}))
    nodes.append(Node(op_type="Add", inputs=["lat16", "up32"], outputs=["p16"]))
    nodes.append(Node(op_type="Resize", inputs=["p16", "", "up_scales"],
                      outputs=["up16"], attrs={"mode": ox.attr_s("mode", "nearest")}))
    nodes.append(Node(op_type="Add", inputs=["lat8", "up16"], outputs=["p8"]))
    nodes.append(Node(op_type="Identity", inputs=["lat32"], outputs=["p32"]))

    # heads: score sigmoid -> [N*A, 1]; bbox -> [N*A, 4]
    score_outs, bbox_outs = [], []
    for lvl, src in [("8", "p8"), ("16", "p16"), ("32", "p32")]:
        init[f"hs{lvl}_w"] = (r.randn(num_anchors, ch * 2, 3, 3) * 0.05).astype(np.float32)
        init[f"hs{lvl}_b"] = np.full(num_anchors, score_bias, np.float32)
        init[f"hb{lvl}_w"] = (r.randn(num_anchors * 4, ch * 2, 3, 3) * 0.05).astype(np.float32)
        init[f"hb{lvl}_b"] = np.full(num_anchors * 4, bbox_bias, np.float32)
        init[f"rs{lvl}_score"] = np.asarray([-1, 1], np.int64)
        init[f"rs{lvl}_bbox"] = np.asarray([-1, 4], np.int64)
        nodes.append(Node(op_type="Conv", inputs=[src, f"hs{lvl}_w", f"hs{lvl}_b"],
                          outputs=[f"s{lvl}_c"],
                          attrs={"pads": ox.attr_ints("pads", (1, 1, 1, 1))}))
        nodes.append(Node(op_type="Sigmoid", inputs=[f"s{lvl}_c"], outputs=[f"s{lvl}_sig"]))
        # NCHW -> NHWC -> flatten: anchor-major per location (reference order)
        nodes.append(Node(op_type="Transpose", inputs=[f"s{lvl}_sig"], outputs=[f"s{lvl}_t"],
                          attrs={"perm": ox.attr_ints("perm", (0, 2, 3, 1))}))
        nodes.append(Node(op_type="Reshape", inputs=[f"s{lvl}_t", f"rs{lvl}_score"],
                          outputs=[f"score_{lvl}"]))
        nodes.append(Node(op_type="Conv", inputs=[src, f"hb{lvl}_w", f"hb{lvl}_b"],
                          outputs=[f"b{lvl}_c"],
                          attrs={"pads": ox.attr_ints("pads", (1, 1, 1, 1))}))
        nodes.append(Node(op_type="Transpose", inputs=[f"b{lvl}_c"], outputs=[f"b{lvl}_t"],
                          attrs={"perm": ox.attr_ints("perm", (0, 2, 3, 1))}))
        nodes.append(Node(op_type="Reshape", inputs=[f"b{lvl}_t", f"rs{lvl}_bbox"],
                          outputs=[f"bbox_{lvl}"]))
        score_outs.append(f"score_{lvl}")
        bbox_outs.append(f"bbox_{lvl}")

    return Model(nodes=nodes, initializers=init, inputs=["input.1"],
                 outputs=score_outs + bbox_outs, name="scrfd_synth")

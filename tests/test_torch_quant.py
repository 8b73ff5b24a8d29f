"""int8 weights (``ops/quant.py``) against the JAX package's ``ops/quant.py``.

Weights are JAX param trees (``init_params`` from a seed, or the hf_tiny
golden through ``convert_state_dict``); JAX's ``quantize_model_params``
quantizes them and ``params_from_jax`` carries the codes across, so both
packages compute on the same codes. Inputs are numpy arrays from a seed;
fp32 on the CPU, where K5 (``w8a16_gemm``) runs its plain version.
"relative" below is max |port - JAX| over max |JAX|: 1e-5 for one product
or lookup, 1e-4 for logits and the vision tower's output. Codes and scales
are compared bit for bit; sessions token for token.
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.data.tokenizer import ByteTokenizer
from livecc_tpu.engine import GenerationParams as JaxGenerationParams
from livecc_tpu.engine import LiveCCEngine as JaxEngine
from livecc_tpu.models import qwen2_vl as jm
from livecc_tpu.ops import quant as jq
from livecc_tpu.serve.scheduler import StreamServer as JaxStreamServer
from livecc_tpu.vision_io.patchify import device_patchify as jax_device_patchify

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer as PortByteTokenizer
from livecc_tpu_torch.demo import cli
from livecc_tpu_torch.engine import GenerationParams, LiveCCEngine
from livecc_tpu_torch.models import qwen2_vl as pm
from livecc_tpu_torch.ops import quant
from livecc_tpu_torch.ops.rope import vision_rotary_cos_sin
from livecc_tpu_torch.serve import StreamServer
from livecc_tpu_torch.vision_io.patchify import device_patchify, grid_for_frames
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "hf_tiny.npz")
T = torch.from_numpy
GEN = dict(max_new_tokens=4, eos_token_id=3, pad_token_id=0, repetition_penalty=1.05)


def rel(port, ref) -> float:
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def tree_np(params):
    return jax.tree_util.tree_map(np.asarray, params)


def tied(cfg):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, tie_word_embeddings=True))


@pytest.fixture(scope="module")
def seeded():
    """{tied: (JAX quantized params, port model from them)} at the tiny config."""
    out = {}
    for is_tied in (False, True):
        jcfg = tied(jax_tiny_config()) if is_tied else jax_tiny_config()
        qparams = jq.quantize_model_params(jm.init_params(jcfg, jax.random.PRNGKey(0)))
        cfg = tied(tiny_config()) if is_tied else tiny_config()
        out[is_tied] = (qparams, pm.params_from_jax(tree_np(qparams), cfg), jcfg, cfg)
    return out


@pytest.fixture(scope="module")
def golden():
    """(JAX params, their numpy tree) of the hf_tiny golden weights, unquantized."""
    g = np.load(GOLDEN)
    state = {k[len("state::"):]: g[k] for k in g.files if k.startswith("state::")}
    params = jm.convert_state_dict(state, jax_tiny_config())
    return params, tree_np(params)


def frames(n, seed=0, h=56, w=28):
    return np.random.RandomState(seed).randint(0, 256, size=(n, h, w, 3), dtype=np.uint8)


def as_bf16_torch(a) -> torch.Tensor:
    """A JAX bf16 array as a torch bf16 tensor (through fp32, exactly)."""
    return T(np.array(jnp.asarray(a, jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["kernel", "embedding"])
def test_quantize_weight_bit_equal_to_jax(dtype, kind):
    """Codes and scales of an ``[in, out]`` kernel (scale over the input
    axis; the port also quantizes its ``[out, in]`` transpose along -1) and
    of a ``[V, H]`` table, in fp32 and in bf16 (the scale rounded to bf16
    before the codes are taken), with ties of w / scale at .5 included."""
    rng = np.random.RandomState(3)
    w = (rng.randn(48, 40) * 0.05).astype(np.float32)
    # column 0 and row 0 have a scale of 1, so their .5 ties round to even
    w[:4, 0] = w[0, :4] = [0.5, -1.5, 2.5, 127.0]
    w[:, 5] = w[5, :] = 0.0                     # all-zero channels: scale 1e-8 / 127
    jw = jnp.asarray(w, dtype)
    axis = -2 if kind == "kernel" else -1
    ref = jq.quantize_weight(jw, scale_axis=axis)
    tw = T(w) if dtype == "float32" else as_bf16_torch(jw)
    out = quant.quantize_weight(tw, scale_axis=axis)
    to_np = (lambda s: s.float().numpy())
    np.testing.assert_array_equal(out["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(to_np(out["scale"]), np.asarray(ref["scale"], np.float32))
    assert out["q"].dtype == torch.int8 and out["scale"].dtype == tw.dtype
    if kind == "kernel":                        # the port's [out, in] layout
        t = quant.quantize_weight(tw.t().contiguous(), scale_axis=-1)
        np.testing.assert_array_equal(t["q"].numpy(), np.asarray(ref["q"]).T)
        np.testing.assert_array_equal(to_np(t["scale"]).reshape(-1),
                                      np.asarray(ref["scale"], np.float32).reshape(-1))


def test_dense_and_embed_lookup_match_jax():
    rng = np.random.RandomState(4)
    w = (rng.randn(64, 96) / 8).astype(np.float32)
    x = rng.randn(3, 5, 64).astype(np.float32)
    node = jq.quantize_weight(jnp.asarray(w), scale_axis=-2)
    tnode = {"q": T(np.asarray(node["q"])), "scale": T(np.asarray(node["scale"]))}
    assert rel(quant.dense(T(x), tnode), jq.dense(jnp.asarray(x), node)) <= 1e-5
    assert rel(quant.dense(T(x), T(w)), jq.dense(jnp.asarray(x), jnp.asarray(w))) <= 1e-5
    table = (rng.randn(50, 32)).astype(np.float32)
    enode = jq.quantize_weight(jnp.asarray(table), scale_axis=-1)
    tenode = {"q": T(np.asarray(enode["q"])), "scale": T(np.asarray(enode["scale"]))}
    ids = rng.randint(0, 50, size=(2, 7))
    assert rel(quant.embed_lookup(tenode, T(ids)), jq.embed_lookup(enode, jnp.asarray(ids))) <= 1e-5


@pytest.mark.parametrize("is_tied", [False, True])
def test_lm_logits_matches_jax(seeded, is_tied):
    """The quantized vocab product, tied (the embedding's codes, transposed)
    and untied (the lm_head's), fp32 out and scaled in fp32."""
    qparams, model, jcfg, cfg = seeded[is_tied]
    assert (model.text.lm_head is None) == is_tied
    hidden = np.random.RandomState(5).randn(2, 3, cfg.text.hidden_size).astype(np.float32)
    out = pm.lm_logits(model.text, cfg.text, T(hidden))
    ref = jm.lm_logits(qparams["text"], jcfg.text, jnp.asarray(hidden))
    assert out.dtype == torch.float32
    assert rel(out, ref) <= 1e-5


@pytest.mark.parametrize("is_tied", [False, True])
def test_quantize_model_matches_jax_codes(is_tied):
    """``quantize_model`` on a model carried across unquantized gives the
    codes and scales JAX's ``quantize_model_params`` gives, on the sites
    JAX quantizes (patch_embed, norms and biases untouched)."""
    jcfg = tied(jax_tiny_config()) if is_tied else jax_tiny_config()
    cfg = tied(tiny_config()) if is_tied else tiny_config()
    params = jm.init_params(jcfg, jax.random.PRNGKey(1))
    ref = pm.params_from_jax(tree_np(jq.quantize_model_params(params)), cfg)
    model = quant.quantize_model(pm.params_from_jax(tree_np(params), cfg))
    got, want = dict(model.state_dict()), dict(ref.state_dict())
    assert set(got) == set(want)
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    n_sites = len(quant.quantized_sites(model))
    assert n_sites == (7 * cfg.text.num_hidden_layers + 1 + (not is_tied)
                       + 4 * cfg.vision.depth + 2)
    assert all(isinstance(getattr(p, a), (quant.QuantLinear, quant.QuantEmbedding))
               for p, a in quant.quantized_sites(model))
    assert isinstance(model.visual.patch_embed, torch.nn.Linear)
    assert not any(isinstance(t, torch.nn.Parameter) for m in model.modules()
                   if isinstance(m, (quant.QuantLinear, quant.QuantEmbedding))
                   for t in m.buffers())
    assert quant.quantize_model(model) is model                 # already quantized: kept
    assert all(torch.equal(t, want[n]) for n, t in model.state_dict().items())


def test_quantized_forward_and_vision_tower_match_jax(seeded):
    """A video prompt through the whole quantized model (logits), and the
    quantized vision tower alone, against JAX on the same codes."""
    from livecc_tpu.data import chat

    qparams, model, jcfg, cfg = seeded[False]
    f = frames(6, seed=3)
    grid = grid_for_frames(6, 56, 28, cfg.vision)
    cos, sin = vision_rotary_cos_sin([grid], cfg.vision.head_dim)
    seg = np.repeat(np.arange(grid[0]), grid[1] * grid[2]).astype(np.int32)
    group = grid[1] * grid[2]
    vis = model.visual(device_patchify(T(f)), T(cos), T(sin), T(seg), group)
    jvis = jm.vision_forward(qparams["visual"], jcfg.vision, jax_device_patchify(jnp.asarray(f)),
                             cos, sin, seg, group)
    assert rel(vis, jvis) <= 1e-4

    text = chat.render_chat([{"role": "user", "content": [
        {"type": "text", "text": "Time=0.0-3.0s"}, {"type": "video", "video": None},
        {"type": "text", "text": "describe"}]}], add_generation_prompt=True)
    ids = np.asarray([ByteTokenizer().encode(chat.expand_vision_placeholders(
        text, video_grid_thw=[grid]))], np.int32)
    pos, _ = pm.get_rope_index(cfg, ids, video_grid_thw=np.asarray([grid]))
    s, smax = ids.shape[1], 256
    jin = jm.VisionInputs(jax_device_patchify(jnp.asarray(f)), jnp.asarray(cos),
                          jnp.asarray(sin), jnp.asarray(seg), group)
    jlogits, _ = jm.forward(qparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), vision=jin,
                            cache=jm.KVCache.zeros(jcfg.text, 1, smax),
                            attention_mask=jnp.arange(smax)[None, :] < s)
    pin = pm.VisionInputs(device_patchify(T(f)), T(cos), T(sin), T(seg), group)
    plogits, _ = pm.forward(model, cfg, T(ids), T(pos), pm.KVCache.zeros(cfg.text, 1, smax),
                            vision=pin)
    assert rel(plogits, jlogits) <= 1e-4


def test_engine_session_matches_jax(golden):
    """``LiveCCEngine(quantize_weights=True)`` on both sides, 3 chunks (a
    6-frame first chunk and two 2-frame ones): the same text."""
    params, tree = golden
    cfg = tiny_config()
    jeng = JaxEngine(params, jax_tiny_config(), ByteTokenizer(), cache_len=512, use_flash=False,
                     quantize_weights=True)
    peng = LiveCCEngine(pm.params_from_jax(tree, cfg), cfg, PortByteTokenizer(), cache_len=512,
                        quantize_weights=True)
    assert isinstance(peng.model.text.embed, quant.QuantEmbedding)
    f = frames(10, seed=1, h=28, w=28)
    ref = jeng.live_cc_once_for_evaluation("describe", f, max_new_tokens=8)
    out = peng.live_cc_once_for_evaluation("describe", f, max_new_tokens=8)
    assert len(out) == 3 and out == ref


def test_pool_int8_kv_matches_jax(golden):
    """JAX's TPU serving configuration on both sides: int8 weights and the
    int8 KV cache, two streams over three ticks, the same text."""
    params, tree = golden
    cfg = tiny_config()
    jeng = JaxEngine(params, jax_tiny_config(), ByteTokenizer(), cache_len=512,
                     cache_dtype=jnp.int8, use_flash=False, quantize_weights=True)
    peng = LiveCCEngine(pm.params_from_jax(tree, cfg), cfg, PortByteTokenizer(), cache_len=512,
                        cache_dtype=torch.int8, quantize_weights=True)
    servers = [JaxStreamServer(jeng, JaxGenerationParams(**GEN), capacity=2),
               StreamServer(peng, GenerationParams(**GEN), capacity=2)]
    texts = []
    for server in servers:
        sids = [server.add_stream((28, 28), query="q") for _ in range(2)]
        out = {sid: [] for sid in sids}
        for tick in range(3):
            n, t0 = (6, 0.0) if tick == 0 else (2, 2.0 + tick)
            for i, sid in enumerate(sids):
                server.submit_chunk(sid, frames(n, seed=10 * i + tick, h=28, w=28), t0,
                                    t0 + n / 2)
            server.tick()
            server.flush()
            for sid in sids:
                out[sid].extend(text for _, text in server.drain(sid))
        texts.append(list(out.values()))
    assert all(len(rows) == 3 for rows in texts[1])
    assert texts[1] == texts[0]


def test_defaults_flag_and_no_gradient(monkeypatch):
    """``quantize_weights=None`` is off on every device; the CLI's flag
    reaches ``build_engine`` (None, True, False) and the engine; a gradient
    through a ``QuantLinear`` raises."""
    cfg = tiny_config()
    model = pm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = LiveCCEngine(model, cfg, PortByteTokenizer())
    assert all(isinstance(getattr(p, a), (torch.nn.Linear, torch.nn.Embedding))
               for p, a in quant.quantized_sites(eng.model))

    class Stop(Exception):
        pass

    seen = []

    def fake_build(model_path, **kw):
        seen.append(kw["quantize_weights"])
        raise Stop

    monkeypatch.setattr(cli, "build_engine", fake_build)
    for flag in ([], ["--quantize-weights"], ["--no-quantize-weights"]):
        with pytest.raises(Stop):
            cli.main(["--video", "clip.mp4", "--device", "cpu", *flag])
    assert seen == [None, True, False]
    monkeypatch.undo()
    engine = cli.build_engine(None, device="cpu", quantize_weights=True)
    assert all(isinstance(getattr(p, a), (quant.QuantLinear, quant.QuantEmbedding))
               for p, a in quant.quantized_sites(engine.model))

    lin = quant.QuantLinear.from_linear(copy.deepcopy(model.text.layers[0].q_proj))
    x = T(np.random.RandomState(6).randn(2, cfg.text.hidden_size).astype(np.float32))
    with torch.no_grad():
        assert lin(x).shape == (2, cfg.text.hidden_size)
    with pytest.raises(RuntimeError, match="serving"):
        lin(x.requires_grad_())
    assert not list(lin.parameters())

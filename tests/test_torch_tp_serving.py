"""Tensor-parallel serving on the CPU: the port's ``LiveCCEngine`` and
``StreamServer`` on a model split by ``parallel/sharding.py:shard_params``
over the mesh's model axis, against the JAX package's sharded engine, pool
and int8 forward (``tests/test_tp_serving.py``, ``tests/test_quant.py:146``).

The weights are the hf_tiny golden (JAX ``convert_state_dict``, carried
across by ``params_from_jax``); inputs are uint8 frames and token ids from
numpy seeds; fp32 throughout. The multi-rank runs are child processes over
gloo (``tests/torch_tp_serving_worker.py``, which imports no JAX): one
launch of 1x2 runs every 1x2 case in turn, one launch of 2x2 the two model
groups, both started before the references are computed here. The JAX
references run on a ``make_mesh(n_data=1, n_model=2)`` mesh of the
8-virtual-device CPU of ``tests/conftest.py``.

M = 2, not JAX's 4: JAX's own test shards the tiny model 4 ways over its 2
KV heads, which GSPMD allows inside a head; the port splits whole heads
(``check_tp`` refuses an M that does not divide Hk), so its cases run at
M = 2 (1 KV head and 2 query heads a rank).

Tolerances: greedy tokens identical to JAX's sharded runs and to the port's
unsharded run; logits within 1e-4 absolute and relative of the unsharded
run (the all-reduce sums the row-split partials in another order); the int8
forward within JAX's own 2e-4; a snapshot's arrays within 1e-5 of the
unsharded pool's.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.core.mesh import make_mesh as jax_make_mesh
from livecc_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from livecc_tpu.engine import GenerationParams as JaxGenerationParams
from livecc_tpu.engine import LiveCCEngine as JaxEngine
from livecc_tpu.models import qwen2_vl as jm
from livecc_tpu.ops.quant import quantize_model_params
from livecc_tpu.parallel.sharding import param_pspecs
from livecc_tpu.parallel.sharding import shard_params as jax_shard_params
from livecc_tpu.serve.scheduler import StreamServer as JaxStreamServer

from livecc_tpu_torch.core import mesh as pmesh
from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer
from livecc_tpu_torch.engine import GenerationParams, LiveCCEngine
from livecc_tpu_torch.engine.graphs import graph_key
from livecc_tpu_torch.models import qwen2_vl as pm
from livecc_tpu_torch.models.qwen2_vl.bridge import _jax_name_map
from livecc_tpu_torch.ops.quant import quantize_model
from livecc_tpu_torch.parallel.sharding import shard_params, split_dim
from livecc_tpu_torch.parallel.tp import TensorParallel
from livecc_tpu_torch.serve import StreamServer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_tp_serving_worker import (
    COMPACT, ENGINE_CHUNKS, GEN, engine_chunks, pool_ticks)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_tp_serving_worker.py")
GOLDEN = os.path.join(HERE, "goldens", "hf_tiny.npz")
TIMEOUT = 300                # seconds the ranks of a launch may take
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
CASES_1X2 = ["engine", "w8", "pool", "snapshot", "sampling", "logits", "controller"]
DISPATCHES = 12


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def launch(root, name, n_data, n_model, args):
    """Start every rank of one mesh; returns (io dir, [(rank, log, process)])."""
    io = root / name
    io.mkdir()
    with open(io / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    world = n_data * n_model
    procs = []
    for r in range(world):
        log = open(io / f"rank{r}.log", "w")
        procs.append((r, log, subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), str(n_data), str(n_model), str(io)],
            env=env, stdout=log, stderr=subprocess.STDOUT)))
    return io, procs


def collect(io, procs) -> list:
    """Every rank's results (a list indexed by rank), once all have exited."""
    try:
        for *_, p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for _, log, p in procs:
            if p.poll() is None:
                p.kill()
            log.close()
    for r, _, p in procs:
        assert p.returncode == 0, (io / f"rank{r}.log").read_text()[-4000:]
    return torch.load(io / "out.pt", weights_only=False)


def tiny_inputs(seed, b, s, start=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, tiny_config().text.vocab_size, size=(b, s)).astype(np.int64)
    pos = np.broadcast_to(np.arange(start, start + s)[None, None], (3, b, s)).astype(np.int64)
    return ids, np.ascontiguousarray(pos)


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    state = {k[len("state::"):]: g[k] for k in g.files if k.startswith("state::")}
    params = jm.convert_state_dict(state, jax_tiny_config())
    return params, quantize_model_params(params)


def port_model(golden, quantized=False):
    """A fresh unsplit port model on the golden weights (JAX's int8 codes
    where ``quantized``)."""
    return pm.params_from_jax(numpy_tree(golden[1] if quantized else golden[0]), tiny_config())


@pytest.fixture(scope="module")
def launched(golden, tmp_path_factory):
    """The 1x2 and 2x2 ranks, started at once; they run while the
    references are computed."""
    root = tmp_path_factory.mktemp("tp_serving")
    base = dict(params=numpy_tree(golden[0]), qparams=numpy_tree(golden[1]))
    ids, pos = tiny_inputs(8, 1, 8)
    chunks = [tiny_inputs(11, 2, 24), tiny_inputs(12, 2, 5, start=24)]
    one = launch(root, "1x2", 1, 2, dict(base, cases=CASES_1X2, ids=ids, pos=pos, chunks=chunks,
                                         dispatches=DISPATCHES))
    two = launch(root, "2x2", 2, 2, dict(base, cases=["groups"]))
    return root, one, two, dict(ids=ids, pos=pos, chunks=chunks)


def jax_engine(params, **kw):
    return JaxEngine(params, jax_tiny_config(), JaxByteTokenizer(), **kw)


@pytest.fixture(scope="module")
def jax_sharded(golden, launched):
    """JAX's sharded runs on a 1x2 mesh, driven as the port's ranks are."""
    params, qparams = golden
    inputs = launched[3]
    gen = JaxGenerationParams(**GEN)
    mesh = jax_make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    out = {}
    with jax.set_mesh(mesh):
        sharded = jax_shard_params(params, mesh)
        out["engine"] = engine_chunks(jax_engine(sharded, **COMPACT), gen, ENGINE_CHUNKS)[0]
        out["w8"] = engine_chunks(jax_engine(sharded, cache_len=256, quantize_weights=True),
                                  gen, 2)[0]
        server = JaxStreamServer(jax_engine(sharded, cache_len=256, cache_dtype=jnp.int8), gen,
                                 capacity=2)
        out["pool"] = pool_ticks(server, 2)[0]
        qsharded = jax_shard_params(qparams, mesh)
        ids, pos = (jnp.asarray(x.astype(np.int32)) for x in (inputs["ids"], inputs["pos"]))
        logits, _ = jax.jit(lambda p: jm.forward(p, jax_tiny_config(), ids, pos))(qsharded)
        out["forward"] = np.asarray(logits)
    return out


def port_engine(model, **kw):
    return LiveCCEngine(model, tiny_config(), ByteTokenizer(), **kw)


@pytest.fixture(scope="module")
def unsharded(golden, launched):
    """The port's single-device runs of the same drives."""
    root, inputs = launched[0], launched[3]
    gen = GenerationParams(**GEN)
    model = port_model(golden)
    out = {}
    eng = port_engine(model, **COMPACT)
    out["engine"], st = engine_chunks(eng, gen, ENGINE_CHUNKS)
    out["logits"] = st.logits
    out["w8"] = engine_chunks(port_engine(quantize_model(port_model(golden)), cache_len=256),
                              gen, 2)[0]
    out["pool"] = pool_ticks(StreamServer(port_engine(model, cache_len=256,
                                                      cache_dtype=torch.int8), gen, capacity=2),
                             2)[0]
    server = StreamServer(port_engine(model, cache_len=256), gen, capacity=2)
    out["snapshot_texts"] = pool_ticks(server, 2)[0]
    path = str(root / "unsharded_snapshot.npz")
    server.snapshot(path)
    out["snapshot"] = dict(np.load(path))
    fresh = StreamServer(port_engine(model, cache_len=256), gen, capacity=2)
    out["after"] = pool_ticks(fresh, 1, sids=fresh.restore(path), start=2)[0]
    cache = pm.KVCache.zeros(tiny_config().text, 2, 64)
    out["cached_logits"] = []
    with torch.no_grad():
        for ids, pos in inputs["chunks"]:
            logits, cache = pm.forward(model, tiny_config(), torch.from_numpy(ids),
                                       torch.from_numpy(pos), cache)
            out["cached_logits"].append(logits)
    out["groups"] = [engine_chunks(port_engine(model, cache_len=256), gen, 2 + d, seed=10 * d,
                                   query=("q", "w")[d])[0] for d in (0, 1)]
    return out


@pytest.fixture(scope="module")
def ranks(launched, jax_sharded, unsharded):
    """{mesh: every rank's results}, once the references exist."""
    _, one, two, _ = launched
    return {"1x2": collect(*one), "2x2": collect(*two), "io": one[0]}


def agreed(every: list, case: str) -> dict:
    """Rank 0's results of ``case`` after checking that every rank's texts
    are the same."""
    first = every[0][case]
    for r, out in enumerate(every):
        assert out[case]["texts"] == first["texts"], (case, r)
    return first


def close(got, ref, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# shard_params: storage, the int8 split rule, refusals (no processes)
# ---------------------------------------------------------------------------

def fake_mesh(n_model, m):
    return pmesh.Mesh(1, n_model, m, None, None, torch.device("cpu"))


def tiny(tied: bool, w8: bool):
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, tie_word_embeddings=tied))
    model = pm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, (quantize_model(model) if w8 else model)


def tensors(model) -> dict:
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("w8", [False, True], ids=["fp32", "int8"])
def test_shard_params_keeps_only_the_shard(tied, w8):
    """At M = 2 (rank 1) every split parameter and int8 buffer owns storage
    of its shard's size and holds rank 1's slice; the replicated ones keep
    their tensors. A dim-0 chunk is a view of the whole storage, which the
    slice without a copy kept alive."""
    cfg, model = tiny(tied, w8)
    whole = {n: t.detach().clone() for n, t in tensors(model).items()}
    kept = {n: t.untyped_storage().data_ptr() for n, t in tensors(model).items()}
    shard_params(model, cfg, fake_mesh(2, 1))
    split = 0
    for name, t in tensors(model).items():
        dim = split_dim(name)
        if dim is None:
            assert t.untyped_storage().data_ptr() == kept[name], name
            assert torch.equal(t, whole[name]), name
            continue
        split += 1
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), name
        assert torch.equal(t, whole[name].chunk(2, dim)[1]), name
    # a layer: q / k / v weights and biases, gate, up, o, down (int8: codes,
    # scales of the five column-split modules, the three biases); the vocab tables
    assert split == 2 * (15 if w8 else 10) + (1 if tied else 2) * (2 if w8 else 1)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_int8_split_dims_match_jax_param_pspecs(tied):
    """Every tensor of a quantized tiny model (codes, scales, biases and the
    rest) against the model-axis entry of JAX ``param_pspecs`` on
    ``quantize_model_params``: codes split as their weight, q / k / v /
    gate / up's and the vocab tables' scales with the output, o and
    down's scales replicated."""
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text,
                                                             tie_word_embeddings=tied))
    cfg, model = tiny(tied, True)
    params = quantize_model_params(jm.init_params(jcfg, jax.random.PRNGKey(0)))
    specs = param_pspecs(params)
    names = _jax_name_map(cfg)
    seen = 0
    for name in tensors(model):
        prefix, leaf = name.rsplit(".", 1)
        if leaf in ("q", "scale"):
            path, layer, transpose = names[f"{prefix}.weight"]
            path, transpose = path + (leaf,), transpose and leaf == "q"
        else:
            path, layer, transpose = names[name]
        spec, node = specs, params
        for key in path:
            spec, node = spec[key], node[key]
        dims = [i - (layer is not None) for i, axis in enumerate(spec) if axis == "model"]
        want = None
        if dims and leaf == "scale":
            want = 0                                # [.., 1, out] / [V, 1] -> the port's [N]
        elif dims:
            (i,) = dims
            ndim = node.ndim - (layer is not None)
            want = ndim - 1 - i if transpose else i
        assert split_dim(name) == want, (name, tuple(spec))
        seen += leaf in ("q", "scale")
    assert seen == 2 * (2 * 7 + 2 * 4 + 2 + 1 + (0 if tied else 1))


def test_int8_weights_refuse_training():
    """The training path keeps its refusal of int8 weights (any M)."""
    cfg, model = tiny(False, True)
    with pytest.raises(NotImplementedError, match="int8 weights do not train"):
        shard_params(model, cfg, fake_mesh(1, 0), training=True)


def test_quantizing_a_split_model_raises():
    """o and down hold a slice of their input channels on a split model, so
    their amax (and codes) would not be the whole model's: quantize first."""
    cfg, model = tiny(False, False)
    shard_params(model, cfg, fake_mesh(2, 0))
    with pytest.raises(ValueError, match="quantize the whole model, then shard_params"):
        quantize_model(model)


def test_graph_key_holds_the_model_group():
    """A captured step bakes in its rank's collectives: the key tells an
    unsplit tower, and each rank of each group size, apart."""
    cfg, model = tiny(False, False)
    cache = pm.KVCache.zeros(cfg.text, 1, 32)
    gen = GenerationParams(**GEN)
    keys = {graph_key(model, gen, cache, 1)}
    for size, rank in ((1, 0), (2, 0), (2, 1)):
        model.text.tp = TensorParallel(None, rank, size)
        keys.add(graph_key(model, gen, cache, 1))
    assert len(keys) == 4


# ---------------------------------------------------------------------------
# the split engine and pool (1x2 over gloo) against JAX's sharded ones
# ---------------------------------------------------------------------------

def test_engine_matches_jax_sharded_engine(ranks, jax_sharded, unsharded):
    """Six chunks through a cache of 256 that compacts (sink 32 + keep 64):
    the same greedy tokens as JAX's sharded engine and the port's unsplit
    one on every rank, one KV head a rank, and the last prefill's logits
    within 1e-4 of the unsplit run's."""
    out = agreed(ranks["1x2"], "engine")
    assert out["texts"] == jax_sharded["engine"] == unsharded["engine"]
    assert out["dropped"] > 0 and out["cache_heads"] == 1
    close(out["logits"], unsharded["logits"], 1e-4, 1e-4, "last prefill logits")


def test_lookahead_matches_plain_decoding_of_the_split_model(ranks):
    """Lookahead decoding (k_draft 3, controller off) on the split model:
    the plain decoding's tokens, with verify windows run."""
    out = agreed(ranks["1x2"], "engine")
    for r, every in enumerate(ranks["1x2"]):
        assert every["engine"]["spec_texts"] == out["texts"], r
    assert out["windows"] > 0


def test_int8_weight_engine_matches_jax_sharded(ranks, jax_sharded, unsharded):
    """The model quantized whole, then split: JAX's sharded engine with
    ``quantize_weights=True`` and the port's unsplit int8 engine."""
    out = agreed(ranks["1x2"], "w8")
    assert out["texts"] == jax_sharded["w8"] == unsharded["w8"]


def test_int8_forward_matches_jax_sharded_forward(ranks, jax_sharded):
    """JAX's int8 codes split by the scale rule: the uncached forward within
    JAX's own 2e-4 of JAX's sharded forward (``test_quant.py:146``), the
    same on every rank."""
    every = ranks["1x2"]
    for out in every:
        assert torch.equal(out["w8"]["forward"], every[0]["w8"]["forward"])
    close(every[0]["w8"]["forward"], jax_sharded["forward"], 2e-4, 2e-4, "int8 forward")


def test_int8_kv_pool_matches_jax_sharded_pool(ranks, jax_sharded, unsharded):
    """Two streams over two ticks in an int8-KV pool of one KV head a rank:
    JAX's sharded pool's tokens and the port's unsplit pool's."""
    out = agreed(ranks["1x2"], "pool")
    assert out["texts"] == jax_sharded["pool"] == unsharded["pool"]
    assert out["cache_heads"] == 1


def test_snapshot_and_restore_of_a_split_pool(ranks, unsharded, golden):
    """The split pool's snapshot holds one card's layout, within 1e-5 of
    the unsplit pool's; restored into a split pool and into an unsplit one,
    both serve the unsplit run's next tick."""
    out = agreed(ranks["1x2"], "snapshot")
    assert out["texts"] == unsharded["snapshot_texts"]
    path = str(ranks["io"] / "snapshot.npz")
    got, ref = dict(np.load(path)), unsharded["snapshot"]
    assert set(got) == set(ref)
    for key in ref:
        if key == "__meta__":
            assert bytes(got[key].tobytes()) == bytes(ref[key].tobytes())
        else:
            assert got[key].shape == ref[key].shape, key
            close(got[key], ref[key], 1e-5, 1e-5, key)
    for r, every in enumerate(ranks["1x2"]):
        assert every["snapshot"]["after"] == unsharded["after"], r
    gen = GenerationParams(**GEN)
    fresh = StreamServer(port_engine(port_model(golden), cache_len=256), gen, capacity=2)
    assert pool_ticks(fresh, 1, sids=fresh.restore(path), start=2)[0] == unsharded["after"]


def test_cached_logits_match_the_unsplit_model(ranks, unsharded):
    """A cached prefill of two rows and a 5-token continuation: logits within
    1e-4 absolute and relative of the unsplit model's, bit-equal across the
    ranks (the all-gather gives each the same)."""
    every = ranks["1x2"]
    out = every[0]["logits"]
    assert out["cache_heads"] == 1
    for got, ref in zip(out["logits"], unsharded["cached_logits"]):
        assert got.shape == ref.shape
        close(got, ref, 1e-4, 1e-4, "cached logits")
    for r in every:
        assert all(torch.equal(a, b) for a, b in zip(r["logits"]["logits"], out["logits"]))


def test_sampled_tokens_agree_on_every_rank(ranks):
    """Sampling (temperature 0.8, top-k 40) from each rank's engine
    generator, seeded alike: every rank draws the same tokens from the same
    gathered logits, over three chunks."""
    every = ranks["1x2"]
    out = agreed(every, "sampling")
    assert len(out["past_ids"]) > 0
    for r in every:
        assert r["sampling"]["past_ids"] == out["past_ids"]


def test_controller_agrees_under_unequal_walls(ranks):
    """Rank 0 measures lookahead faster, rank 1 plain decoding: alone their
    controllers choose apart, which would part the ranks' collectives; with
    the walls agreed over the model group they choose alike."""
    a, b = (r["controller"] for r in ranks["1x2"])
    assert len(a["agreed"]) == DISPATCHES
    assert a["agreed"] == b["agreed"]
    assert a["alone"] != b["alone"]


def test_two_model_groups_serve_apart(ranks, unsharded):
    """2x2: each data rank's model group serves its own stream (data rank 1
    one chunk more), equal to the port's unsplit run of that stream; no
    collective crosses the data axis, or the groups' sequences would part."""
    every = ranks["2x2"]
    for r, out in enumerate(every):
        g = out["groups"]
        assert (g["d"], g["m"]) == divmod(r, 2)
        assert g["texts"] == unsharded["groups"][g["d"]], r
    assert len(every[2]["groups"]["texts"]) == 3

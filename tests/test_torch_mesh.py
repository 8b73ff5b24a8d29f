"""Multi-device training on the CPU: the port's mesh, TP and ZeRO-2 against
the JAX package's (data, model) mesh.

All in fp32 on the tiny config (4 heads, 2 KV heads, vocab 1024). The
multi-rank cases run each rank in a child process over gloo
(``tests/torch_mesh_worker.py``, which imports no JAX; the ranks meet at a
``file://`` rendezvous under ``tmp_path``), each child on one torch thread,
each case under its own timeout. The JAX references run here, on the
8-virtual-device CPU mesh of ``tests/conftest.py``.

  * the rank layout (``core/mesh.py:layout``) against JAX ``make_mesh`` for
    1x1, 2x1, 1x2, 2x2 and 4x2; the split dim of every tiny parameter
    (``parallel/sharding.py:split_dim``) against JAX ``param_pspecs`` through
    the bridge's name map, tied and untied;
  * ``vocab_parallel_ce`` over 2 ranks against JAX's under ``shard_map`` at
    V = 64 and V = 61 (pad columns): loss within 1e-6, count equal, both
    gradients within 1e-5 norm-relative, the pad columns' gradient 0;
  * two windows (accum 2) at 2x2 and 2x1 against JAX's ``make_train_step``
    jitted on a mesh of that shape in ``Trainer``'s layout
    (``trainer.py:92-112``), clipping firing (JAX's first-window mu holds a
    gradient of norm ``max_grad_norm``): losses within 1e-5, tokens equal,
    every parameter and both moments within 1e-5 relative + 1e-6 (mu) /
    1e-9 (nu) absolute, the replicated parameters bit-equal across the
    model ranks; 2x1 and 1x2 (also with ``ce_sup_bucket``) against the
    port's single-device step the same way. The ranks' ``Zero2`` stages
    its gradients through a bucket of ``BUCKET`` elements (each partition
    cut into several buckets, each reduced once a micro-step); 2x1 also
    with the ViT trained and video in data rank 0's rows only (rank 1's
    forward skips the ViT) against the single-device step;
  * ZeRO-2 holds only the partition: on every rank at 2x1 and 2x2 the fp32
    gradient is ``part`` elements, ``Zero2``'s fp32 gradient buffers total
    the plan's ``grads_bytes`` exactly, no trainable parameter holds a
    ``.grad`` after a backward, and no hook is left after the steps; the
    same runs with one bucket's reduction skipped (a planted fault) fail
    the parameter and moment limits;
  * ``torchrun -m livecc_tpu_torch.train.cli --mesh 2x1 --device cpu`` for
    3 steps on a text corpus: ``log.jsonl``'s losses within 1e-5 and tokens
    equal to JAX ``Trainer(mesh=make_mesh(2, 1))`` on the same weights,
    corpus and seed;
  * a checkpoint saved at 2x1 resumes at 1x1 and 1x2 (and in the
    single-card ``Trainer``) to the step that continues at 2x1;
  * the refusals: M not dividing the KV heads, DATA x MODEL != WORLD_SIZE,
    torchrun's environment missing (also with ``--seq_shard``, which
    ``tests/test_torch_seq_shard.py`` holds). Serving on a split
    model, int8 weights under TP and the training path's refusal of them
    are ``tests/test_torch_tp_serving.py``'s.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.core.mesh import make_mesh as jax_make_mesh
from livecc_tpu.data.lmm_dataset import LMMDataset as JaxDataset
from livecc_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from livecc_tpu.models import qwen2_vl as jm
from livecc_tpu.ops.chunked_ce import vocab_parallel_ce as jax_vocab_parallel_ce
from livecc_tpu.parallel.sharding import param_pspecs
from livecc_tpu.train import data as jdata
from livecc_tpu.train import step as jstep
from livecc_tpu.train import trainer as jtrainer

from livecc_tpu_torch.core import mesh as pmesh
from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.lmm_dataset import write_seek_index
from livecc_tpu_torch.models import qwen2_vl as pm
from livecc_tpu_torch.models.qwen2_vl.bridge import _jax_name_map
from livecc_tpu_torch.parallel.sharding import shard_params, split_dim
from livecc_tpu_torch.train import cli
from livecc_tpu_torch.train import data as pdata
from livecc_tpu_torch.train import step as pstep
from livecc_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_torch_train import make_sample
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_mesh_worker.py")
CASE_TIMEOUT = 240         # seconds a multi-rank case may take
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# the windows' train config: lr and eps as the port's step tests (eps 1e-6
# keeps AdamW's step of a ~0 gradient, a key bias's, off its noise)
STEP_KW = dict(learning_rate=1e-4, total_steps=10, warmup_ratio=0.1, ce_chunk_size=16,
               adam_eps=1e-6, max_grad_norm=0.05)


def child_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return env


def run_ranks(tmp_path, *jobs) -> list:
    """Every rank of each ``(case, n_data, n_model, args)`` job, all jobs at
    once; each job's rank-0 results."""
    runs = []
    for case, n_data, n_model, args in jobs:
        io = tmp_path / f"{case}_{n_data}x{n_model}_{len(list(tmp_path.iterdir()))}"
        io.mkdir()
        with open(io / "args.pkl", "wb") as f:
            pickle.dump(args, f)
        world = n_data * n_model
        for r in range(world):
            log = open(io / f"rank{r}.log", "w")
            runs.append((io, r, log, subprocess.Popen(
                [sys.executable, WORKER, case, str(r), str(world), str(n_data), str(n_model),
                 str(io)], env=child_env(), stdout=log, stderr=subprocess.STDOUT)))
    try:
        for *_, p in runs:
            p.wait(timeout=CASE_TIMEOUT)
    finally:
        for _, _, log, p in runs:
            if p.poll() is None:
                p.kill()
            log.close()
    for io, r, _, p in runs:
        assert p.returncode == 0, (io / f"rank{r}.log").read_text()[-4000:]
    return [torch.load(io / "out.pt", weights_only=False) for io, r, _, _ in runs if r == 0]


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_names(tree, cfg) -> dict:
    """A JAX param-shaped tree (or a trainable subtree) as ``{port name:
    array in the port's layout}``."""
    out = {}
    for name, (path, layer, transpose) in _jax_name_map(cfg).items():
        node = tree
        try:
            for key in path:
                node = node[key]
        except (KeyError, TypeError):
            continue
        arr = np.asarray(node)
        if layer is not None:
            arr = arr[layer]
        out[name] = arr.T if transpose else arr
    return out


def jax_tree_from(model, cfg) -> dict:
    """The port model's weights as a JAX param tree (the bridge reversed)."""
    tree = numpy_tree(jm.init_params(jax_tiny_config(), jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map(np.array, tree)
    for name, p in model.named_parameters():
        path, layer, transpose = _jax_name_map(cfg)[name]
        node = tree
        for key in path[:-1]:
            node = node[key]
        arr = p.detach().numpy()
        arr = arr.T if transpose else arr
        if layer is None:
            node[path[-1]] = arr
        else:
            node[path[-1]][layer] = arr
    return jax.tree_util.tree_map(jnp.asarray, tree)


def close(got, ref, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(jax_tiny_config(), jax.random.PRNGKey(0))


def window_samples():
    """4 samples with video: one window of accum 2 x 2 rows."""
    rng = np.random.RandomState(6)
    return [make_sample(tiny_config(), n, rng, with_video=True) for n in (30, 44, 26, 36)]


def mixed_samples():
    """``window_samples``' lengths with video in the even rows only: at 2x1
    data rank 1's rows carry none, so its steps skip the ViT."""
    rng = np.random.RandomState(7)
    return [make_sample(tiny_config(), n, rng, with_video=i % 2 == 0)
            for i, n in enumerate((30, 44, 26, 36))]


# the ViT trained too (``--freeze_modules`` with no module)
VIT_KW = dict(STEP_KW, freeze_modules=())

# Zero2's staging bucket in the ranks: smaller than a data rank's partition of
# the tiny model (about 51k-103k elements), so each partition is cut into
# several buckets and a micro-step reduces several
BUCKET = 30_000


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory, jax_params):
    """``(n_data, n_model, ce_sup_bucket) -> `` rank 0's results of the
    ``step`` case over two windows of ``window_samples`` (each mesh
    launched once; at n_data > 1 with the planted run too, and at 2x1 with
    a run of ``mixed_samples`` under ``VIT_KW`` in ``also``)."""
    cache = {}

    def run(n_data, n_model, ce_bucket=None):
        key = (n_data, n_model, ce_bucket)
        if key not in cache:
            also = [dict(samples=mixed_samples(), tcfg=VIT_KW)] if key == (2, 1, None) else []
            cache[key], = run_ranks(tmp_path_factory.mktemp("step"), ("step", n_data, n_model, dict(
                params=numpy_tree(jax_params), samples=window_samples(),
                tcfg=dict(STEP_KW, ce_sup_bucket=ce_bucket), windows=2, bucket=BUCKET,
                plant=n_data > 1, also=also)))
        return cache[key]

    return run


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory, jax_params):
    """``(n_data, n_model) ->`` two windows of JAX's step jitted on its
    mesh with ``Trainer``'s shardings (the same batch each window): (the
    metrics, parameters, mu, nu in the port's names)."""
    cache = {}

    def run(n_data, n_model):
        if (n_data, n_model) in cache:
            return cache[n_data, n_model]
        cfg, jcfg = tiny_config(), jax_tiny_config()
        jc = jstep.TrainConfig(**STEP_KW)
        mesh = jax_make_mesh(n_data=n_data, n_model=n_model,
                             devices=jax.devices()[:n_data * n_model])
        jt = jtrainer.Trainer(jax_params, jcfg, jc, jtrainer.TrainerConfig(
            output_dir=str(tmp_path_factory.mktemp("jax")), resume=False), dataset=[], mesh=mesh)
        batch = jt._place_batch(jdata.collate(window_samples(), jcfg, rows=2))
        params, state, jmetrics = jt.params, jt.opt_state, []
        for w in range(2):
            params, state, m = jt.step_fn(params, state, batch)
            jmetrics.append(m)
            if w == 0:  # mu = (1 - b1) * clipped g: clipping fired iff its norm is the max
                g = jnp.sqrt(sum(jnp.sum(x.astype(jnp.float32) ** 2)
                                 for x in jax.tree_util.tree_leaves(state[1][0].mu)))
                assert abs(float(g) / (1 - jc.adam_b1) - jc.max_grad_norm) < 1e-6
        cache[n_data, n_model] = (jmetrics, *(port_names(numpy_tree(t), cfg) for t in (
            params, state[1][0].mu, state[1][0].nu)))
        return cache[n_data, n_model]

    return run


# ---------------------------------------------------------------------------
# layout and split rules (no processes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_data,n_model", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2)])
def test_rank_layout_matches_jax_make_mesh(n_data, n_model):
    """rank = d * n_model + m: JAX's device at (d, m) of ``make_mesh`` over
    the first n devices is device ``layout[d, m]``, and a Mesh of that rank
    sits at (d, m)."""
    devs = jax.devices()[:n_data * n_model]
    ids = np.vectorize(lambda d: d.id)(jax_make_mesh(n_data, n_model, devices=devs).devices)
    first = min(d.id for d in devs)
    layout = pmesh.layout(n_data, n_model)
    np.testing.assert_array_equal(layout, ids - first)
    for (d, m), rank in np.ndenumerate(layout):
        mesh = pmesh.Mesh(n_data, n_model, int(rank), None, None, torch.device("cpu"))
        assert (mesh.d, mesh.m) == (d, m)


@pytest.mark.parametrize("tied", [False, True])
def test_split_dims_match_jax_param_pspecs(tied):
    """Every tiny parameter's split dim, through the bridge's name map
    (JAX [L, in, out] kernels, the port's [out, in] weights), against the
    model-axis entry of JAX ``param_pspecs``."""
    import dataclasses

    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text,
                                                             tie_word_embeddings=tied))
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, tie_word_embeddings=tied))
    params = jm.init_params(jcfg, jax.random.PRNGKey(0))
    specs = param_pspecs(params)
    names = _jax_name_map(cfg)
    assert set(names) == {n for n, _ in pm.Qwen2VL(cfg).named_parameters()}
    for name, (path, layer, transpose) in names.items():
        spec, leaf = specs, params
        for key in path:
            spec, leaf = spec[key], leaf[key]
        dims = [i for i, axis in enumerate(spec) if axis == "model"]
        want = None
        if dims:
            (i,) = dims
            ndim = leaf.ndim - (layer is not None)          # the port's tensor: one layer
            i -= layer is not None
            want = ndim - 1 - i if transpose else i
        assert split_dim(name) == want, (name, tuple(spec))


# ---------------------------------------------------------------------------
# the vocab-parallel CE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v_total", [64, 61])
def test_vocab_parallel_ce_matches_jax(tmp_path, v_total):
    """2 ranks, vocab split (61: the last shard has a pad column): loss,
    count and the gradients of hidden and kernel against JAX's
    ``vocab_parallel_ce`` under ``shard_map`` (``tests/test_pipeline.py``)."""
    rng = np.random.RandomState(7)
    b, s, h = 2, 37, 16                                 # 37 % 16 != 0: the chunk pad leg
    hidden = rng.randn(b, s, h).astype(np.float32)
    kernel = (rng.randn(h, v_total) / 4).astype(np.float32)
    labels = rng.randint(0, v_total, size=(b, s)).astype(np.int32)
    labels[0, :10] = -100
    v_pad = -v_total % 2
    mesh = jax_make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])

    def sharded(hid, ker):
        def f(hid, ker, lab):
            return jax_vocab_parallel_ce(hid, ker, lab, axis_name="model", v_total=v_total,
                                         chunk_size=16)
        return jax.shard_map(f, mesh=mesh, in_specs=(P(), P(None, "model"), P()),
                             out_specs=(P(), P()))(hid, ker, jnp.asarray(labels))

    def mean(hid, ker):
        loss, count = sharded(hid, ker)
        return loss / jnp.maximum(count, 1)

    ker_p = jnp.pad(jnp.asarray(kernel), ((0, 0), (0, v_pad)))
    with jax.set_mesh(mesh):
        loss, count = sharded(jnp.asarray(hidden), ker_p)
        gh, gk = jax.grad(mean, argnums=(0, 1))(jnp.asarray(hidden), ker_p)
    out, = run_ranks(tmp_path, ("ce", 1, 2, dict(hidden=hidden, kernel=kernel, labels=labels,
                                                 chunk_size=16)))
    np.testing.assert_allclose(float(out["loss"]), float(loss), rtol=1e-6)
    assert int(out["count"]) == int(count)
    for got, ref in ((out["d_hidden"], gh), (out["d_kernel"][:, :v_total], gk[:, :v_total])):
        ref = np.asarray(ref)
        assert np.linalg.norm(got.numpy() - ref) <= 1e-5 * np.linalg.norm(ref)
    assert out["d_kernel"].shape == (h, v_total + v_pad)
    assert float(out["d_kernel"][:, v_total:].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# the mesh step
# ---------------------------------------------------------------------------

def check_state(out, params, mu, nu, cfg):
    """The gathered state against whole parameters and moments (port names)."""
    got = out["state"]
    for name, ref in params.items():
        close(got["params"][name], ref, 1e-5, 1e-6, name)
    assert set(got["opt_state"]["mu"]) == set(mu)
    for name in mu:
        close(got["opt_state"]["mu"][name], mu[name], 1e-5, 1e-6, "mu " + name)
        close(got["opt_state"]["nu"][name], nu[name], 1e-5, 1e-9, "nu " + name)
    assert out["replicated_in_sync"]


def hold_jax(out, ref, cfg):
    """A run's losses, tokens and gathered state against ``jax_sharded``'s."""
    jmetrics, params, mu, nu = ref
    for mine, m in zip(out["metrics"], jmetrics):
        np.testing.assert_allclose(mine["loss"], float(m["loss"]), rtol=1e-5)
        assert mine["tokens"] == int(m["tokens"]) > 0
    check_state(out, params, mu, nu, cfg)


def test_mesh_step_2x2_matches_jax_sharded_step(step_runs, jax_sharded):
    """Two windows of accum 2 on a 2x2 mesh against JAX's step jitted on its
    2x2 mesh with ``Trainer``'s shardings (the same batch each window)."""
    hold_jax(step_runs(2, 2), jax_sharded(2, 2), tiny_config())


def test_mesh_step_2x1_matches_jax_sharded_step(step_runs, jax_sharded):
    """The same at 2x1: ZeRO-2 over two data ranks, the model whole."""
    hold_jax(step_runs(2, 1), jax_sharded(2, 1), tiny_config())


def single_device_windows(jax_params, n_data, ce_bucket=None, samples=None, kw=STEP_KW):
    """Two windows of the port's single-device step under ``kw`` on
    ``samples`` (``window_samples`` by default) collated as a mesh of
    ``n_data`` data ranks takes them: (metrics, parameters, mu, nu)."""
    cfg = tiny_config()
    tcfg = pstep.TrainConfig(**dict(kw, ce_sup_bucket=ce_bucket))
    model = pm.params_from_jax(numpy_tree(jax_params), cfg)
    opt = pstep.make_optimizer(tcfg)
    state = opt.init(pstep.split_frozen(model, tcfg.freeze_modules)[0])
    step = pstep.make_train_step(cfg, tcfg, opt)
    batch = pdata.collate(samples or window_samples(), cfg, rows=n_data, device="cpu")
    ref = []
    for _ in range(2):
        model, state, m = step(model, state, batch)
        ref.append(m)
    return (ref, {n: p.detach().numpy() for n, p in model.named_parameters()},
            {n: t.numpy() for n, t in state["mu"].items()},
            {n: t.numpy() for n, t in state["nu"].items()})


@pytest.mark.parametrize("n_data,n_model,bucket", [(2, 1, None), (1, 2, None), (1, 2, 48)])
def test_mesh_step_matches_single_device_step(step_runs, jax_params, n_data, n_model, bucket):
    """2x1 (2 rows a micro-step over 2 data ranks) and 1x2 (the model split
    in two), the latter also with ``ce_sup_bucket`` (each model rank
    gathers the same supervised rows), against the port's single-device
    step on the same window."""
    ref, params, mu, nu = single_device_windows(jax_params, n_data, bucket)
    out = step_runs(n_data, n_model, bucket)
    for mine, m in zip(out["metrics"], ref):
        np.testing.assert_allclose(mine["loss"], float(m["loss"]), rtol=1e-5)
        assert mine["tokens"] == int(m["tokens"]) > 0
        assert mine["ce_dropped"] == int(m["ce_dropped"]) == 0
    check_state(out, params, mu, nu, tiny_config())


def test_mesh_step_trains_a_vit_one_data_rank_skips(step_runs, jax_params):
    """At 2x1 with the ViT trained, data rank 0's rows carry video and rank
    1's none (its forward skips the ViT, so the ViT's parameters get no
    gradient there): both ranks still reduce the same buckets, rank 1's ViT
    part as zeros, and the two windows match the port's single-device step
    on the same rows, with the ViT's moments nonzero."""
    ref, params, mu, nu = single_device_windows(jax_params, 2, samples=mixed_samples(),
                                                kw=VIT_KW)
    out, = step_runs(2, 1)["also"]
    for mine, m in zip(out["metrics"], ref):
        np.testing.assert_allclose(mine["loss"], float(m["loss"]), rtol=1e-5)
        assert mine["tokens"] == int(m["tokens"]) > 0
    assert any(name.startswith("visual.") for name in mu)
    assert max(np.abs(t).max() for name, t in mu.items() if name.startswith("visual.")) > 0
    check_state(out, params, mu, nu, tiny_config())
    check_partition(out["zero"], 4)
    assert len({f["reduces"] for f in out["zero"]}) == 1


def check_partition(facts, micro_steps):
    """Every rank's ``torch_mesh_worker.zero_facts``: the fp32 gradient is
    the partition, its buffers and the parameters are the plan's bytes, no
    ``.grad`` after any backward, no hook after the steps."""
    assert sorted(f["rank"] for f in facts) == list(range(len(facts)))
    for f in facts:
        assert f["grad_numel"] == f["part"] and f["flat"] % f["part"] == 0, f
        assert f["fp32_grad_bytes"] == f["plan_grads_bytes"], f
        assert f["weights_bytes"] == f["plan_weights_bytes"], f
        assert f["grads_left"] == [0] * micro_steps, f
        assert f["hooked"] == 0, f


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (2, 2)])
def test_zero2_holds_only_the_partition(step_runs, n_data, n_model):
    """At 2x1 and 2x2, on every rank: ``zero.grad`` is ``part`` elements
    (half the flat buffer), its fp32 buffers (partition and bucket) are the
    plan's ``grads_bytes``, no ``.grad`` survives a backward (2 windows x
    accum 2), the hooks are gone after the step, and the bucket, smaller
    than the flat buffer, was reduced several times a micro-step."""
    facts = step_runs(n_data, n_model)["zero"]
    check_partition(facts, 4)
    for f in facts:
        assert f["flat"] == n_data * f["part"] and 0 < f["bucket"] == BUCKET < f["flat"]
        assert f["reduces"] >= 4 * -(-f["flat"] // BUCKET), f
    assert len({f["reduces"] for f in facts}) == 1


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (2, 2)])
def test_a_skipped_bucket_reduction_fails(step_runs, jax_sharded, jax_params, n_data, n_model):
    """The same windows with the first bucket run's ``dist.reduce`` skipped
    on every rank (its owner keeps only its own gradient there) fail the
    parameter and moment limits that the real run meets, against JAX's
    sharded step (2x2) and the port's single-device step (2x1)."""
    planted = step_runs(n_data, n_model)["planted"]
    cfg = tiny_config()
    if n_model == 2:
        ref = jax_sharded(2, 2)[1:]
    else:
        ref = single_device_windows(jax_params, n_data)[1:]
    with pytest.raises(AssertionError):
        check_state(planted, *ref, cfg)


# ---------------------------------------------------------------------------
# the CLI under torchrun, and checkpoints across meshes
# ---------------------------------------------------------------------------

TEXT_ROWS = [("what is the score?", "two to one for the home side"),
             ("who scored the second?", "the number nine, with a header at the far post"),
             ("how long is left?", "about ten minutes and the away side presses"),
             ("was it offside?", "no, he timed the run well")]


def test_torchrun_cli_mesh_2x1_matches_jax_trainer(tmp_path):
    """``torchrun -m livecc_tpu_torch.train.cli --mesh 2x1 --device cpu``
    (tiny random init, byte tokenizer) for 3 steps, against JAX's
    ``Trainer(mesh=make_mesh(2, 1))`` on the same weights, corpus and seed:
    the log's losses and tokens."""
    corpus = tmp_path / "qa.jsonl"
    with open(corpus, "w") as f:
        for q, a in TEXT_ROWS:
            f.write(json.dumps([{"role": "user", "content": [{"type": "text", "text": q}]},
                                {"role": "assistant", "content": [{"type": "text", "text": a}]}])
                    + "\n")
    write_seek_index(str(corpus))
    flags = ["--annotation_paths", str(corpus), "--total_steps", "3", "--accum_steps", "2",
             "--log_steps", "1", "--learning_rate", "1e-3", "--warmup_ratio", "0",
             "--dataloader_num_workers", "1", "--save_steps", "100"]
    out = tmp_path / "torch"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "livecc_tpu_torch.train.cli", *flags, "--output_dir", str(out),
           "--mesh", "2x1", "--device", "cpu"]
    run = subprocess.run(cmd, env=child_env(), capture_output=True, text=True,
                         timeout=CASE_TIMEOUT, cwd=str(tmp_path))
    assert run.returncode == 0, (run.stdout + run.stderr)[-4000:]
    log = [json.loads(x) for x in (out / "log.jsonl").read_text().splitlines()]

    cfg, jcfg = tiny_config(), jax_tiny_config()
    model = pm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")   # the CLI's init
    dataset = JaxDataset(annotation_paths=[str(corpus)], tokenizer=JaxByteTokenizer(), cfg=jcfg)
    jt = jtrainer.Trainer(
        jax_tree_from(model, cfg), jcfg,
        jstep.TrainConfig(learning_rate=1e-3, warmup_ratio=0.0, total_steps=3),
        jtrainer.TrainerConfig(output_dir=str(tmp_path / "jax"), total_steps=3, accum_steps=2,
                               save_steps=100, log_steps=1, loader_workers=1),
        dataset, mesh=jax_make_mesh(2, 1, devices=jax.devices()[:2]))
    jt.train()
    ref = [json.loads(x) for x in (tmp_path / "jax" / "log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [r["step"] for r in ref] == [1, 2, 3]
    for mine, r in zip(log, ref):
        assert mine["tokens"] == r["tokens"] > 0
        np.testing.assert_allclose(mine["loss"], r["loss"], rtol=1e-5)


def test_checkpoint_at_2x1_resumes_on_any_mesh_and_one_card(tmp_path, jax_params):
    """Step 1 saved at 2x1 (accum 1: 2 samples a window); step 2 taken at
    2x1, at 1x1 and 1x2 (accum 2: the same 2 samples a window) and by the
    single-card ``Trainer`` from the same file: the same loss, tokens and
    parameters."""
    xs = window_samples()
    tcfg = dict(STEP_KW, max_grad_norm=1.0)
    base = dict(params=numpy_tree(jax_params), samples=xs, tcfg=tcfg)

    def run_kw(out, steps, accum):
        return dict(output_dir=str(out), total_steps=steps, accum_steps=accum, save_steps=1,
                    log_steps=1, loader_workers=1)

    first = tmp_path / "first"
    run_ranks(tmp_path, ("trainer", 2, 1, dict(base, run=run_kw(first, 1, 1))))
    assert (first / "ckpt" / "1" / "state.pt").exists()
    dirs = {}
    for name in ("2x1", "1x1", "1x2", "card"):
        dirs[name] = tmp_path / f"resume_{name}"
        shutil.copytree(first, dirs[name])
    meshes = {"2x1": (2, 1, 1), "1x1": (1, 1, 2), "1x2": (1, 2, 2)}     # n_data, n_model, accum
    outs = run_ranks(tmp_path, *[("trainer", nd, nm, dict(base, run=run_kw(dirs[name], 2, accum)))
                                 for name, (nd, nm, accum) in meshes.items()])
    last = dict(zip(meshes, outs))
    cfg = tiny_config()
    trainer = Trainer(pm.params_from_jax(numpy_tree(jax_params), cfg), cfg,
                      pstep.TrainConfig(**tcfg), TrainerConfig(**run_kw(dirs["card"], 2, 2)), xs)
    assert trainer.step == 1
    last["card"] = {"last": trainer.train()}
    ref = last["2x1"]["last"]
    assert ref["step"] == 2 and ref["restored_step"] == 1
    want = torch.load(dirs["2x1"] / "ckpt" / "2" / "state.pt")
    for name, got in last.items():
        assert got["last"]["step"] == 2 and got["last"]["tokens"] == ref["tokens"] > 0, name
        np.testing.assert_allclose(got["last"]["loss"], ref["loss"], rtol=1e-5, err_msg=name)
        state = torch.load(dirs[name] / "ckpt" / "2" / "state.pt")
        assert state["step"] == 2 and state["opt_state"]["count"] == 2
        for n, p in want["params"].items():
            close(state["params"][n], p, 1e-5, 1e-6, f"{name} {n}")
        for n, p in want["opt_state"]["nu"].items():
            close(state["opt_state"]["nu"][n], p, 1e-5, 1e-9, f"{name} nu {n}")


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def fake_mesh(n_data, n_model):
    return pmesh.Mesh(n_data, n_model, 0, None, None, torch.device("cpu"))


def test_model_axis_must_divide_the_kv_heads():
    cfg = tiny_config()                      # 2 KV heads
    model = pm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="num_key_value_heads"):
        shard_params(model, cfg, fake_mesh(1, 4))


@pytest.mark.parametrize("env,error,match", [
    ({}, RuntimeError, "torchrun"),
    ({"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
      "MASTER_PORT": "1"}, ValueError, "WORLD_SIZE 2"),
])
def test_init_mesh_refuses(monkeypatch, env, error, match):
    """torchrun's environment missing, and a 2x2 mesh over WORLD_SIZE 2:
    both raise before any process group starts."""
    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    with pytest.raises(error, match=match):
        pmesh.init_mesh("2x2", "cpu")
    assert not torch.distributed.is_initialized()


def test_cli_seq_shard_raises(tmp_path, monkeypatch):
    """``--mesh 1x2 --seq_shard`` passes the CLI's own check (MODEL >= 2)
    and, outside torchrun, raises torchrun's error as ``--mesh`` does."""
    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.main(["--annotation_paths", "none.jsonl", "--output_dir", str(tmp_path),
                  "--mesh", "1x2", "--seq_shard", "--device", "cpu"])

"""Pipeline parallelism on the CPU: the port's ``parallel/pipeline.py``
(``shard_params_pp``, ``make_pp_train_step``: GPipe fill-drain over
point-to-point stages, the vocab-parallel CE after the drain, ZeRO-2 per
stage) against the JAX package's ``make_pp_train_step`` and single-device
step, as ``tests/test_pipeline.py`` holds JAX's pipeline.

fp32 on the tiny config cut to 4 layers (tied embeddings, so the embedding
collects stage 0's lookup gradient and every stage's CE slice), and on the
2-layer untied tiny config for the packed batch. The ranks are child
processes over gloo (``tests/torch_sp_pp_worker.py``, which imports no
JAX): one launch each of (data, stages) = (1, 1), (1, 2), (2, 2) and (1, 4), started
before the JAX references are computed here (each JAX step compiled once).
Every case takes two windows of A = 4 microbatches with clipping firing
(``STEP_KW``; the first update has learning rate 0, the second moves the
parameters):

  * (1, 2) against JAX's ``make_pp_train_step`` on its 1x2 mesh;
  * (1, 1), (2, 2) and (1, 4) against JAX's single-device
    ``make_train_step`` (at one stage no point-to-point call is issued);
  * a packed batch (int32 segment ids, S = 45) at (1, 2) against JAX's
    single-device step.

``Zero2`` stages its gradients through ``test_torch_mesh.BUCKET`` elements;
on every rank it holds only the data rank's partition of its stage's fp32
gradient (``test_torch_mesh.check_partition`` against the plan with
``pipeline=True``).

Limits, ``tests/test_pipeline.py``'s: loss within 1e-5 relative, tokens
equal, parameters and the AdamW moments within 2e-4 relative + 1e-6 (nu:
1e-9) absolute. Besides: ``pp_split`` against JAX ``pp_param_pspecs``
through the bridge's name map (tied and untied), a stage's storage after
``shard_params_pp``, the point-to-point calls each stage issues, and the
refusals (vision fields; stages not dividing the layers).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.core.mesh import make_mesh as jax_make_mesh
from livecc_tpu.models import qwen2_vl as jm
from livecc_tpu.parallel.pipeline import make_pp_train_step as jax_make_pp_train_step
from livecc_tpu.parallel.pipeline import pp_param_pspecs
from livecc_tpu.parallel.pipeline import shard_params_pp as jax_shard_params_pp
from livecc_tpu.train import step as jstep

from livecc_tpu_torch.core import mesh as pmesh
from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.models import qwen2_vl as pm
from livecc_tpu_torch.models.qwen2_vl.bridge import _jax_name_map
from livecc_tpu_torch.parallel.pipeline import (
    OtherStage, make_pp_train_step, pp_split, shard_params_pp)
from livecc_tpu_torch.parallel.sharding import Zero2
from livecc_tpu_torch.train import step as pstep
from test_torch_mesh import BUCKET, STEP_KW, check_partition, close, numpy_tree, port_names
from test_torch_seq_shard import collect, launch, packed_batch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ACCUM, ROWS, SEQ = 4, 2, 32
MESHES = ((1, 1), (1, 2), (2, 2), (1, 4))


def config(cfg, layers, tied):
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_hidden_layers=layers, tie_word_embeddings=tied))


def text_batch(seed=0):
    """``tests/test_pipeline.py``'s text batch: [A, B, S] ids, the tail half
    supervised, positions 0..S-1, a bool mask of ones."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(8, tiny_config().text.vocab_size, size=(ACCUM, ROWS, SEQ)).astype(np.int32)
    labels = ids.copy()
    labels[:, :, :SEQ // 2] = -100
    pos = np.broadcast_to(np.arange(SEQ)[None, None, None], (ACCUM, 3, ROWS, SEQ)).astype(np.int32)
    return dict(input_ids=ids, labels=labels, position_ids=np.ascontiguousarray(pos),
                attention_mask=np.ones((ACCUM, ROWS, SEQ), bool))


BATCHES = {"text": text_batch(), "packed": packed_batch(5, ACCUM, 1)}
# case -> (layers, tied, batch)
CASES = {"text": (4, True, "text"), "packed": (2, False, "packed")}


def jax_batch(name):
    return jstep.Batch(**{k: jnp.asarray(v) for k, v in BATCHES[name].items()})


def jax_init(layers, tied):
    return jm.init_params(config(jax_tiny_config(), layers, tied), jax.random.PRNGKey(1))


def worker_case(name):
    layers, tied, batch = CASES[name]
    return dict(kind="pp", params=numpy_tree(jax_init(layers, tied)), layers=layers, tied=tied,
                batch=BATCHES[batch], tcfg=STEP_KW, windows=2, bucket=BUCKET)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every mesh's ranks, started at once; they run while the JAX
    references are computed."""
    root = tmp_path_factory.mktemp("pipeline")
    out = {}
    for n_data, n_stage in MESHES:
        names = ["text", "packed"] if (n_data, n_stage) == (1, 2) else ["text"]
        out[(n_data, n_stage)] = (names, launch(root, f"{n_data}x{n_stage}", n_data, n_stage,
                                                [worker_case(n) for n in names]))
    return out


def two_windows(step, params, state, batch):
    metrics = []
    for _ in range(2):
        params, state, m = step(params, state, batch)
        metrics.append((float(m["loss"]), int(m["tokens"])))
    adam = state[1][0]
    return metrics, params, adam.mu, adam.nu


@pytest.fixture(scope="module")
def jax_runs(launched):
    """JAX's single-device step on each case, and its pipeline step at
    (1, 2) on the text case: (losses and tokens, parameters, mu, nu) in the
    port's names."""
    tcfg = jstep.TrainConfig(**STEP_KW)
    out = {}
    for name, (layers, tied, batch) in CASES.items():
        params = jax_init(layers, tied)
        opt = jstep.make_optimizer(tcfg)
        state = opt.init(jstep.split_frozen(params, tcfg.freeze_modules)[0])
        out[name] = two_windows(jax.jit(jstep.make_train_step(config(jax_tiny_config(), layers,
                                                                     tied), tcfg, opt)),
                                params, state, jax_batch(batch))
    mesh = jax_make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    cfg = config(jax_tiny_config(), 4, True)
    params = jax_shard_params_pp(jax_init(4, True), mesh)
    opt = jstep.make_optimizer(tcfg)
    state = opt.init(jstep.split_frozen(params, tcfg.freeze_modules)[0])
    with jax.set_mesh(mesh):
        out["pp"] = two_windows(jax.jit(jax_make_pp_train_step(cfg, tcfg, opt, mesh)),
                                params, state, jax_batch("text"))
    return {k: (m, *(port_names(numpy_tree(t), config(tiny_config(), *CASES[
        "text" if k == "pp" else k][:2])) for t in rest)) for k, (m, *rest) in out.items()}


@pytest.fixture(scope="module")
def results(launched, jax_runs):
    """Each mesh's cases: {case: [every rank's result]}."""
    out = {}
    for mesh, (names, job) in launched.items():
        ranks = collect(*job)
        out[mesh] = {name: [r[i] for r in ranks] for i, name in enumerate(names)}
    return out


def merged(ranks) -> tuple[dict, dict, dict]:
    """The whole parameters and moments from data rank 0 of every stage."""
    params, mu, nu = {}, {}, {}
    for r in ranks:
        if r["data"] == 0:
            params.update(r["params"])
            mu.update(r["moments"]["mu"])
            nu.update(r["moments"]["nu"])
    return params, mu, nu


def hold(ranks, ref):
    metrics, params, mu, nu = ref
    for r in ranks:
        for mine, (loss, tokens) in zip(r["metrics"], metrics):
            np.testing.assert_allclose(mine["loss"], loss, rtol=1e-5)
            assert mine["tokens"] == tokens > 0
    got, got_mu, got_nu = merged(ranks)
    assert set(got) == set(params) and set(got_mu) == set(mu)
    for name, want in params.items():
        close(got[name], want, 2e-4, 1e-6, name)
    for name in mu:
        close(got_mu[name], mu[name], 2e-4, 1e-6, "mu " + name)
        close(got_nu[name], nu[name], 2e-4, 1e-9, "nu " + name)


def test_pp_1x2_matches_jax_pipeline_step(results, jax_runs):
    """(1, 2) against JAX's ``make_pp_train_step`` on its 1x2 mesh."""
    hold(results[(1, 2)]["text"], jax_runs["pp"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_pp_matches_jax_single_device_step(results, jax_runs, mesh):
    """Every mesh against JAX's single-device step."""
    hold(results[mesh]["text"], jax_runs["text"])


def test_pp_packed_batch_matches_jax_single_device_step(results, jax_runs):
    """int32 segment ids at (1, 2) (``tests/test_pipeline.py:109``)."""
    hold(results[(1, 2)]["packed"], jax_runs["packed"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_pp_point_to_point_calls(results, mesh):
    """Each stage sends and receives one activation a microbatch forward
    and one gradient backward along its edges of the chain: the first and
    last stages A a window each way, a middle stage 2A, a lone stage none."""
    n_stage = mesh[1]
    for r in results[mesh]["text"]:
        edges = (r["stage"] > 0) + (r["stage"] < n_stage - 1)
        want = edges * r["accum"] * len(r["metrics"])
        assert r["calls"].get("send", 0) == r["calls"].get("recv", 0) == want


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_zero2_holds_only_the_partition(results, mesh):
    """On every rank (each stage at each data index): the fp32 gradient is
    the data rank's partition of its stage's flat buffer, ``Zero2``'s fp32
    buffers the plan's ``grads_bytes`` (``pipeline=True``), no ``.grad``
    after any of the window's backwards (A for the CE, A for the layers),
    no hook after the steps."""
    ranks = results[mesh]["text"]
    for r in ranks:
        check_partition(r["zero"], 2 * r["accum"] * len(r["metrics"]))
        assert all(f["flat"] == mesh[0] * f["part"] for f in r["zero"])


@pytest.mark.parametrize("tied", [False, True])
def test_pp_split_matches_jax_pp_param_pspecs(tied):
    """Every parameter's pipeline split, through the bridge's name map:
    split exactly where JAX's spec puts the model axis on the stacked layer
    axis, and at the layer the map reads."""
    cfg = config(tiny_config(), 4, tied)
    params = jm.init_params(config(jax_tiny_config(), 4, tied), jax.random.PRNGKey(0))
    specs = pp_param_pspecs(params)
    names = _jax_name_map(cfg)
    assert set(names) == {n for n, _ in pm.Qwen2VL(cfg).named_parameters()}
    for name, (path, layer, _) in names.items():
        spec = specs
        for key in path:
            spec = spec[key]
        split = tuple(spec)[:1] == ("model",)
        assert (pp_split(name) is not None) == split, (name, tuple(spec))
        assert pp_split(name) == (layer if split else None), name


def fake_mesh(n_data, n_model, rank=0):
    return pmesh.Mesh(n_data, n_model, rank, None, None, torch.device("cpu"))


@pytest.mark.parametrize("n_stage,stage", [(2, 0), (2, 1), (4, 2)])
def test_a_stage_keeps_only_its_layers(n_stage, stage):
    """After ``shard_params_pp`` a stage's parameters are its layers and the
    replicated ones, and their storage is exactly those tensors' bytes; the
    other layers' places raise when called."""
    cfg = config(tiny_config(), 4, True)
    whole = pm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    per = 4 // n_stage
    own = range(stage * per, (stage + 1) * per)
    want = {n: p.numel() * p.element_size() for n, p in whole.named_parameters()
            if pp_split(n) is None or pp_split(n) in own}
    shard_params_pp(whole, cfg, fake_mesh(1, n_stage, stage))
    params = dict(whole.named_parameters())
    assert set(params) == set(want)
    storages = {p.untyped_storage().data_ptr(): p.untyped_storage().nbytes()
                for p in params.values()}
    assert sum(storages.values()) == sum(want.values())
    other = next(i for i in range(4) if i not in own)
    assert isinstance(whole.text.layers[other], OtherStage)
    with pytest.raises(RuntimeError, match=f"stage {other // per}"):
        whole.text.layers[other](None, None, None, None)


def test_stages_must_divide_the_layers():
    cfg = config(tiny_config(), 4, False)
    model = pm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="4 must divide into 3 stages"):
        shard_params_pp(model, cfg, fake_mesh(1, 3))


def test_pp_step_refuses_vision_fields():
    """Text-only, as JAX's (the frozen-ViT recipe): a batch with video
    raises before any collective."""
    from test_torch_train import make_sample

    from livecc_tpu_torch.train import data as pdata

    cfg = tiny_config()
    model = pm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = fake_mesh(1, 1)
    shard_params_pp(model, cfg, mesh)
    tcfg = pstep.TrainConfig(**STEP_KW)
    zero = Zero2(pstep.split_frozen(model, tcfg.freeze_modules)[0], mesh, split=pp_split)
    step = make_pp_train_step(cfg, tcfg, pstep.make_optimizer(tcfg), mesh, zero)
    sample = make_sample(cfg, 30, np.random.RandomState(0), with_video=True)
    batch = pdata.collate([sample], cfg, device="cpu")
    with pytest.raises(ValueError, match="text-only"):
        step(model, zero.init_state(None), batch)

"""Sequence parallelism on the CPU: the port's ``TrainConfig(seq_shard=True)``
(Megatron SP over the model axis: ``parallel/tp.py``'s sequence
collectives, ``models/qwen2_vl/text.py``'s split tower) against the JAX
package's ``seq_shard`` step jitted on the same mesh and against the port's
own TP step.

fp32 on the tiny config (2 layers, 4 heads, 2 KV heads, vocab 1024). The
ranks are child processes over gloo (``tests/torch_sp_pp_worker.py``, which
imports no JAX): one launch of 1x2 and one of 2x2, each running its cases
in turn, both started before the JAX references are computed here on the
8-virtual-device CPU mesh of ``tests/conftest.py``. Every case takes two
windows with clipping firing (``STEP_KW``: max_grad_norm 0.05; the first
update has learning rate 0, the second moves the parameters) under
remat=True unless it says otherwise:

  * ``video``: ``window_samples`` (bool masks, every row with video; the
    ViT's embeddings are scattered before the split);
  * ``packed``: int32 segment ids (three packed samples and pad, segment
    0) at S = 45, which M = 2 does not divide (the tower pads to 46 and
    cuts);
  * ``masked``: a bool mask with pad keys at S = 37, remat=False;
  * ``doubled``: ``video`` with the exit's backward reduce-scattered (a
    planted fault: the gradient that reaches the exit is already the whole
    sum on every model rank, so a reduce-scatter doubles it at M = 2).

``Zero2`` stages its gradients through ``test_torch_mesh.BUCKET`` elements.
On every rank of both meshes it holds only the data rank's partition of
the fp32 gradient (``test_torch_mesh.check_partition``: the plan's
``grads_bytes``, no ``.grad`` after a backward, no hook after the steps).

Limits: against JAX (2x2 ``video``, 1x2 ``packed``): losses within 1e-5,
tokens equal, parameters and both moments within 1e-5 relative + 1e-6
(nu: 1e-9) absolute, as ``tests/test_torch_mesh.py``; against the port's
TP step (every case): JAX's own ``seq_shard`` limits
(``tests/test_train_step.py:152``): loss 1e-6 relative, parameters and
moments 1e-5 relative + 1e-7 absolute. ``doubled`` must fail them.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.core.mesh import make_mesh as jax_make_mesh
from livecc_tpu.models import qwen2_vl as jm
from livecc_tpu.train import data as jdata
from livecc_tpu.train import step as jstep
from livecc_tpu.train import trainer as jtrainer

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.models import qwen2_vl as pm
from livecc_tpu_torch.models.qwen2_vl.text import text_forward
from test_torch_mesh import (BUCKET, STEP_KW, check_partition, close, numpy_tree, port_names,
                             window_samples)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_sp_pp_worker.py")
TIMEOUT = 240                # seconds the ranks of a launch may take
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
CASES_1X2 = ("video", "packed", "masked", "doubled")
CASES_2X2 = ("video", "packed")


def launch(root, name, n_data, n_model, cases):
    """Start every rank of one mesh; returns (io dir, [(rank, log, process)])."""
    io = root / name
    io.mkdir()
    with open(io / "args.pkl", "wb") as f:
        pickle.dump(cases, f)
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
    """Every rank's results (indexed by rank, then by case), once all have exited."""
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
    return [torch.load(io / f"out{r}.pt", weights_only=False) for r, _, _ in procs]


def packed_batch(seed, accum, rows, s=45):
    """int32 segment ids: per row packed samples of 12-20 tokens (positions
    restarting, each sample's first label -100, its head unsupervised),
    then pad (segment 0)."""
    rng = np.random.RandomState(seed)
    vocab = tiny_config().text.vocab_size
    ids = np.zeros((accum, rows, s), np.int32)
    labels = np.full((accum, rows, s), -100, np.int32)
    pos = np.zeros((accum, 3, rows, s), np.int32)
    seg = np.zeros((accum, rows, s), np.int32)
    for a in range(accum):
        for r in range(rows):
            at = k = 0
            while True:
                n = rng.randint(12, 21)
                if at + n > s - 2:
                    break
                k += 1
                ids[a, r, at:at + n] = rng.randint(8, vocab, size=n)
                labels[a, r, at + n // 2:at + n] = ids[a, r, at + n // 2:at + n]
                pos[a, :, r, at:at + n] = np.arange(n)
                seg[a, r, at:at + n] = k
                at += n
    return dict(input_ids=ids, labels=labels, position_ids=pos, attention_mask=seg)


def masked_batch(seed, accum, rows, s=37):
    """A bool mask: each row's first 25-33 tokens valid, then pad keys."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(8, tiny_config().text.vocab_size, size=(accum, rows, s)).astype(np.int32)
    mask = np.zeros((accum, rows, s), bool)
    for a in range(accum):
        for r in range(rows):
            mask[a, r, :rng.randint(25, 34)] = True
    labels = np.where(mask, ids, -100).astype(np.int32)
    labels[:, :, :s // 2] = -100
    pos = np.broadcast_to(np.arange(s)[None, None, None], (accum, 3, rows, s)).astype(np.int32)
    return dict(input_ids=ids, labels=labels, position_ids=np.ascontiguousarray(pos),
                attention_mask=mask)


def cases_for(params, n_data, names):
    base = dict(kind="sp", params=params, tcfg=STEP_KW, windows=2, bucket=BUCKET)
    table = {"video": dict(samples=window_samples()),
             "packed": dict(batch=packed_batch(3, 2, n_data)),
             "masked": dict(batch=masked_batch(4, 2, n_data), tcfg=dict(STEP_KW, remat=False)),
             "doubled": dict(samples=window_samples(), exit_doubled=True)}
    return [dict(base, **table[n]) for n in names]


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(jax_tiny_config(), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def launched(jax_params, tmp_path_factory):
    """The 1x2 and 2x2 ranks, started at once; they run while the JAX
    references are computed."""
    root = tmp_path_factory.mktemp("seq_shard")
    params = numpy_tree(jax_params)
    one = launch(root, "1x2", 1, 2, cases_for(params, 1, CASES_1X2))
    two = launch(root, "2x2", 2, 2, cases_for(params, 2, CASES_2X2))
    return {"1x2": one, "2x2": two}


@pytest.fixture(scope="module")
def jax_runs(jax_params, launched, tmp_path_factory):
    """JAX's ``seq_shard`` step jitted on its 2x2 mesh (``video``) and 1x2
    mesh (``packed``) in ``Trainer``'s shardings, two windows each: (losses,
    tokens, parameters, mu, nu) in the port's names."""
    cfg, jcfg = tiny_config(), jax_tiny_config()
    root = tmp_path_factory.mktemp("jax_seq_shard")
    out = {}
    for name, (n_data, n_model) in (("video", (2, 2)), ("packed", (1, 2))):
        mesh = jax_make_mesh(n_data=n_data, n_model=n_model,
                             devices=jax.devices()[:n_data * n_model])
        jt = jtrainer.Trainer(jax_params, jcfg, jstep.TrainConfig(**STEP_KW, seq_shard=True),
                              jtrainer.TrainerConfig(output_dir=str(root / name), resume=False),
                              dataset=[], mesh=mesh)
        if name == "video":
            batch = jdata.collate(window_samples(), jcfg, rows=2)
        else:
            batch = jstep.Batch(**{k: jax.numpy.asarray(v)
                                   for k, v in packed_batch(3, 2, n_data).items()})
        batch = jt._place_batch(batch)
        params, state, metrics = jt.params, jt.opt_state, []
        with jax.set_mesh(mesh):
            for _ in range(2):
                params, state, m = jt.step_fn(params, state, batch)
                metrics.append((float(m["loss"]), int(m["tokens"])))
        adam = state[1][0]
        out[name] = (metrics, *(port_names(numpy_tree(t), cfg)
                                for t in (params, adam.mu, adam.nu)))
    return out


@pytest.fixture(scope="module")
def results(launched, jax_runs):
    """Rank 0's result of each case, by mesh and case name (after the JAX
    references, so that both ran at once)."""
    out = {}
    for mesh, names in (("1x2", CASES_1X2), ("2x2", CASES_2X2)):
        ranks = collect(*launched[mesh])
        out[mesh] = dict(zip(names, ranks[0]))
    return out


def hold(run, ref, loss_rtol, rtol, atol, atol_nu):
    """A run's gathered state and losses against a reference run's."""
    got, want = run["state"], ref["state"]
    for mine, r in zip(run["metrics"], ref["metrics"]):
        np.testing.assert_allclose(mine["loss"], r["loss"], rtol=loss_rtol)
        assert mine["tokens"] == r["tokens"] > 0
    for name, t in want["params"].items():
        close(got["params"][name], t, rtol, atol, name)
    for key, tol in (("mu", atol), ("nu", atol_nu)):
        for name, t in want["opt_state"][key].items():
            close(got["opt_state"][key][name], t, rtol, tol, f"{key} {name}")


@pytest.mark.parametrize("mesh,case", [("2x2", "video"), ("1x2", "packed")])
def test_seq_shard_matches_jax_seq_shard_step(results, jax_runs, mesh, case):
    """Two windows of the port's SP step against JAX's ``seq_shard`` step
    on the same mesh: losses, tokens, every parameter and both moments."""
    run = results[mesh][case]["sp"]
    metrics, params, mu, nu = jax_runs[case]
    for mine, (loss, tokens) in zip(run["metrics"], metrics):
        np.testing.assert_allclose(mine["loss"], loss, rtol=1e-5)
        assert mine["tokens"] == tokens > 0
    state = run["state"]
    for name, ref in params.items():
        close(state["params"][name], ref, 1e-5, 1e-6, name)
    assert set(state["opt_state"]["mu"]) == set(mu)
    for name in mu:
        close(state["opt_state"]["mu"][name], mu[name], 1e-5, 1e-6, "mu " + name)
        close(state["opt_state"]["nu"][name], nu[name], 1e-5, 1e-9, "nu " + name)
    assert run["replicated_in_sync"]


@pytest.mark.parametrize("mesh,case", [("1x2", c) for c in CASES_1X2 if c != "doubled"]
                         + [("2x2", c) for c in CASES_2X2])
def test_seq_shard_matches_the_tp_step(results, mesh, case):
    """SP against the port's TP step from the same weights on the same
    windows, within JAX's own ``seq_shard`` limits; the replicated
    parameters stay bit-equal across the model ranks."""
    r = results[mesh][case]
    hold(r["sp"], r["tp"], 1e-6, 1e-5, 1e-7, 1e-7)
    assert r["sp"]["replicated_in_sync"] and r["tp"]["replicated_in_sync"]


def test_a_doubled_exit_gradient_fails(results):
    """The exit's backward reduce-scattered instead of cut (the gradient
    there doubled at M = 2) fails the TP limits that the right exit meets."""
    r = results["1x2"]["doubled"]
    with pytest.raises(AssertionError):
        hold(r["sp"], r["tp"], 1e-6, 1e-5, 1e-7, 1e-7)
    hold(results["1x2"]["video"]["sp"], r["tp"], 1e-6, 1e-5, 1e-7, 1e-7)


@pytest.mark.parametrize("mesh,case", [("1x2", c) for c in CASES_1X2 if c != "doubled"]
                         + [("2x2", c) for c in CASES_2X2])
def test_seq_shard_collectives_per_micro_step(results, mesh, case):
    """The sequence collectives a window issues, against what the code
    implies for L layers a micro-step: all-gathers 2L + 1 forward (q / k /
    v and gate / up, the exit) and 2L + 1 backward (the reduce-scatters'
    and the entry's); reduce-scatters 2L forward and 2L backward; under
    remat=True the recompute of each layer re-issues its two gathers and
    o's reduce-scatter (torch's checkpoint stops once down_proj has saved
    its input, before down's reduce-scatter); plus ZeRO-2's one all-gather
    a window (its gradient is reduced into the partition during the
    backward, with no reduce-scatter at the update). The TP step issues
    only ZeRO-2's."""
    r = results[mesh][case]
    n_layers = tiny_config().text.num_hidden_layers
    remat = case != "masked"
    micro = r["sp"]["micro_steps"]
    windows = len(r["sp"]["metrics"])
    gathers = (4 * n_layers + 2 + (2 * n_layers if remat else 0)) * micro + windows
    scatters = (4 * n_layers + (n_layers if remat else 0)) * micro
    assert r["sp"]["calls"].get("all_gather", 0) == gathers
    assert r["sp"]["calls"].get("reduce_scatter", 0) == scatters
    assert r["tp"]["calls"].get("all_gather", 0) == windows
    assert r["tp"]["calls"].get("reduce_scatter", 0) == 0


@pytest.mark.parametrize("mesh,case", [("1x2", "video"), ("2x2", "video"), ("2x2", "packed")])
def test_zero2_holds_only_the_partition(results, mesh, case):
    """On every rank, in both the SP and the TP run: the fp32 gradient is
    the data rank's partition and the plan's bytes, no ``.grad`` after a
    backward, no hook after the steps; at 2x2 the bucket was reduced at
    least once a micro-step, the same number of times on every rank, and
    at 1x2 (one data rank) never."""
    for run in (results[mesh][case]["sp"], results[mesh][case]["tp"]):
        facts = run["zero"]
        check_partition(facts, run["micro_steps"])
        reduces = {f["reduces"] for f in facts}
        if mesh == "1x2":
            assert reduces == {0} and all(f["bucket"] == 0 for f in facts)
        else:
            assert len(reduces) == 1 and min(reduces) >= run["micro_steps"]


def test_seq_shard_needs_a_model_group():
    """``seq_shard`` on a tower that no ``shard_params`` split raises, as
    JAX's needs an active mesh with a model axis."""
    cfg = tiny_config()
    model = pm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    embeds = torch.zeros((1, 8, cfg.text.hidden_size))
    pos = torch.zeros((3, 1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="model group"):
        text_forward(model.text, cfg.text, embeds, pos, seq_shard=True)

"""The port's training path against the JAX package's (tiny config, fp32, CPU).

Weights come from one JAX ``init_params`` carried across by
``params_from_jax``; samples and batches are numpy arrays from a seed. The
JAX side runs its CPU path (``mha`` with the packed mask), the port K4's
plain version with splash semantics: pad rows differ between the two, but
pads are right-padded and label-masked, so the loss, every gradient and the
updated parameters agree (hidden states are compared on valid rows only).

Tolerances: hidden states 1e-5; gradients 1e-5 of each tensor's largest
entry (elementwise, entries with cancelling sums carry fp32 noise); per-step
losses rtol 1e-5; updated parameters rtol 1e-5 / atol 1e-6 after steps of
learning rate 1e-4 with Adam's eps at 1e-6. Adam divides each gradient by
its own size, so an entry whose gradient is near zero turns fp32 noise into
a step of up to the learning rate; the step size and eps set what atol can
resolve. ``test_loss_fn_grads_match_jax`` holds the gradients themselves.
"""

import dataclasses
import os
import random
import warnings

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from livecc_tpu.core.config import tiny_config as jax_tiny_config
from livecc_tpu.models import qwen2_vl as jm
from livecc_tpu.train import data as jdata
from livecc_tpu.train import step as jstep
from livecc_tpu.vision_io.patchify import patchify_video

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.models import qwen2_vl as pm
from livecc_tpu_torch.train import data as pdata
from livecc_tpu_torch.train import step as pstep
from livecc_tpu_torch.train.trainer import Trainer, TrainerConfig
from livecc_tpu_torch.utils import flops as pflops
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.from_numpy


def make_sample(cfg, n_tokens, rng, with_video=False, frames=(4, 28, 56)):
    """A processed sample in ``LMMDataset``'s schema (tail half supervised)."""
    ids = rng.randint(8, cfg.text.vocab_size, size=(1, n_tokens)).astype(np.int32)
    patches = grid = None
    if with_video:
        t, h, w = frames
        clip = rng.randint(0, 255, size=(t, 3, h, w)).astype(np.uint8)
        patches, g = patchify_video(clip)
        grid = np.asarray([g])
        n_vid = patches.shape[0] // 4
        ids[0, 0] = cfg.vision_start_token_id
        ids[0, 1:1 + n_vid] = cfg.video_token_id
        ids[0, 1 + n_vid] = cfg.vision_end_token_id
    labels = ids.copy()
    labels[:, : n_tokens // 2] = -100
    pos, _ = pm.get_rope_index(cfg, ids, video_grid_thw=grid)
    return {"input_ids": ids, "labels": labels, "position_ids": pos,
            "pixel_patches": patches, "video_grid_thw": grid,
            "image_patches": None, "image_grid_thw": None}


def samples(seed, lens, with_video=True):
    rng = np.random.RandomState(seed)
    return [make_sample(tiny_config(), n, rng, with_video=with_video) for n in lens]


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(jax_tiny_config(), jax.random.PRNGKey(0))


def port_model(params):
    return pm.params_from_jax(jax.tree_util.tree_map(np.asarray, params), tiny_config())


def assert_params_equal(model, params, rtol=1e-5, atol=1e-6):
    ref = port_model(params)
    got = dict(model.named_parameters())
    for name, p in ref.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(), p.detach().numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# the uncached text tower
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_uncached_text_forward_remat_and_jax(jax_params, masked):
    """remat=True grads equal remat=False grads, and both equal JAX's
    ``text_forward(cache=None, remat=True)`` (hidden states on valid rows,
    a loss on valid rows)."""
    jcfg, cfg = jax_tiny_config().text, tiny_config().text
    rng = np.random.RandomState(0)
    b, s = 2, 40
    emb = rng.randn(b, s, cfg.hidden_size).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None, None], (3, b, s)).astype(np.int32)
    mask = np.stack([np.arange(s) < 33, np.arange(s) < 21]) if masked else None
    valid = mask if masked else np.ones((b, s), bool)
    w = rng.randn(b, s, cfg.hidden_size).astype(np.float32) * valid[..., None]

    def port_grads(remat):
        model = port_model(jax_params)
        pstep.split_frozen(model, ("visual",))
        h, cache = pm.text_forward(model.text, cfg, T(emb), T(pos),
                                   attention_mask=None if mask is None else T(mask), remat=remat)
        assert cache is None
        (h * T(w)).sum().backward()
        return h.detach().numpy(), {n: p.grad.numpy() for n, p in model.text.named_parameters()
                                    if p.grad is not None}

    h0, g0 = port_grads(False)
    h1, g1 = port_grads(True)
    np.testing.assert_array_equal(h0, h1)
    for n in g0:
        np.testing.assert_allclose(g1[n], g0[n], rtol=1e-6, atol=1e-7, err_msg=n)

    def jloss(p):
        h, _ = jm.text_forward(p, jcfg, jnp.asarray(emb), jnp.asarray(pos),
                               attention_mask=None if mask is None else jnp.asarray(mask),
                               remat=True)
        return jnp.sum(h * w), h

    (_, jh), jg = jax.value_and_grad(jloss, has_aux=True)(jax_params["text"])
    np.testing.assert_allclose(h0[valid], np.asarray(jh)[valid], atol=1e-5, rtol=0)
    grads = port_model({"visual": jax_params["visual"], "text": jg})
    ref = dict(grads.text.named_parameters())
    assert len(g0) == len(ref) - 2                 # all but the unused embed and lm_head
    for n in g0:                                   # max abs error <= 1e-5 of the tensor's scale
        r = ref[n].detach().numpy()
        assert np.abs(g0[n] - r).max() <= 1e-5 * np.abs(r).max(), n


def test_named_remat_policies_raise():
    """The named policies are served (``test_remat_policy_matches_false_and_jax``);
    a name that is none of ``REMAT_POLICIES`` raises, in the forward and in
    ``TrainConfig``."""
    cfg = tiny_config()
    model = pm.Qwen2VL(cfg)
    x = torch.zeros(1, 4, cfg.text.hidden_size)
    pos = torch.zeros(3, 1, 4, dtype=torch.int32)
    for policy in ("name", "everything", 1, None):
        with pytest.raises(ValueError, match="remat"):
            pm.text_forward(model.text, cfg.text, x, pos, remat=policy)
        with pytest.raises(ValueError, match="remat"):
            pstep.TrainConfig(remat=policy)
    for policy in pm.text.REMAT_POLICIES:
        assert pstep.TrainConfig(remat=policy).remat == policy


REMATS = [False, True, "names", "names_mlp", "dots"]


def remat_run(params, remat, emb, pos, w):
    """The uncached text tower of the tiny port model (trainable params)
    under ``remat``: (loss, {name: grad}, bytes kept for the backward,
    products the backward runs). Bytes: the distinct storages that reach
    ``saved_tensors_hooks`` (a checkpoint region's inputs among them; the
    parameters are not counted). Products: aten mm / addmm calls during
    ``backward()`` (each product's two gradients plus its recomputation)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = tiny_config().text
    model = port_model(params)
    pstep.split_frozen(model, ("visual",))
    skip = {p.untyped_storage().data_ptr() for p in model.parameters()}
    kept = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            kept[st.data_ptr()] = st.nbytes()
        return t

    class Products(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
                Products.n += 1
            return func(*args, **(kwargs or {}))

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        h, _ = pm.text_forward(model.text, cfg, T(emb), T(pos), remat=remat)
    loss = (h * T(w)).sum()
    with Products():
        loss.backward()
    grads = {n: p.grad.numpy() for n, p in model.text.named_parameters() if p.grad is not None}
    return float(loss.detach()), grads, sum(kept.values()), Products.n


@pytest.fixture(scope="module")
def remat_runs(jax_params):
    rng = np.random.RandomState(3)
    b, s, h = 1, 48, tiny_config().text.hidden_size
    emb, w = (rng.randn(b, s, h).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(s)[None, None], (3, b, s)).astype(np.int32)
    return (emb, pos, w), {r: remat_run(jax_params, r, emb, pos, w) for r in REMATS}


@pytest.mark.parametrize("remat", REMATS)
def test_remat_policy_matches_false_and_jax(jax_params, remat_runs, remat):
    """Each policy's loss and gradients equal remat=False's (fp32, 1e-5 of
    each gradient's scale) and JAX's ``text_forward`` under the same policy
    (``remat_policy``). The named policies' regions split the layer's ops
    without running one twice, so their backward graph is remat=True's:
    loss and gradients bit-equal to it."""
    (emb, pos, w), runs = remat_runs
    loss, grads, _, _ = runs[remat]
    ref_loss, ref_grads, _, _ = runs[False]
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
    assert grads.keys() == ref_grads.keys()
    for n, g in grads.items():
        assert np.abs(g - ref_grads[n]).max() <= 1e-5 * np.abs(ref_grads[n]).max(), n
    if remat:
        assert loss == runs[True][0]
        for n, g in grads.items():
            np.testing.assert_array_equal(g, runs[True][1][n], err_msg=n)

    def jloss(p):
        h, _ = jm.text_forward(p, jax_tiny_config().text, jnp.asarray(emb), jnp.asarray(pos),
                               remat=remat)
        return jnp.sum(h * w)

    jl, jg = jax.value_and_grad(jloss)(jax_params["text"])
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    ref = dict(port_model({"visual": jax_params["visual"], "text": jg}).text.named_parameters())
    for n, g in grads.items():
        r = ref[n].detach().numpy()
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max(), n


def test_remat_policies_keep_ordered_bytes_and_rerun_no_kept_product(remat_runs):
    """Bytes kept for the backward, strictly: True < "names" < "names_mlp"
    < False and "names" < "dots" < False, so a policy that silently equals
    True or False fails. And the products the backward runs (two
    gradients of each of the 7 per layer, plus what it recomputes): a
    region's recomputation stops at its last product's saved inputs, so
    True reruns all but down_proj; "names" and "names_mlp" rerun q and k
    (their region ends with v) and gate and up (whose outputs silu's
    backward reads, as in JAX); "dots" q, k and gate (its gate / up region
    ends with up)."""
    _, runs = remat_runs
    kept = {r: run[2] for r, run in runs.items()}
    assert kept[True] < kept["names"] < kept["names_mlp"] < kept[False], kept
    assert kept["names"] < kept["dots"] < kept[False], kept
    layers = tiny_config().text.num_hidden_layers
    products = {r: run[3] for r, run in runs.items()}
    assert products == {False: 14 * layers, True: 20 * layers, "names": 18 * layers,
                        "names_mlp": 18 * layers, "dots": 17 * layers}, products


# ---------------------------------------------------------------------------
# host collation
# ---------------------------------------------------------------------------

def assert_batch_equal(port_batch, jax_batch):
    for f in dataclasses.fields(jax_batch):
        j = getattr(jax_batch, f.name)
        p = getattr(port_batch, f.name)
        if j is None or isinstance(j, int):
            assert p == j, f.name
        else:
            np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=f.name)


@pytest.mark.parametrize("rows", [1, 2])
def test_collate_matches_jax(rows):
    cfg, jcfg = tiny_config(), jax_tiny_config()
    xs = samples(1, [24, 40, 18, 56])
    assert_batch_equal(pdata.collate(xs, cfg, rows=rows, device="cpu"),
                       jdata.collate(xs, jcfg, rows=rows))


def test_pack_samples_matches_jax():
    xs = samples(2, [30, 30, 50, 90, 10, 40], with_video=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for max_rows in (None, 1, 2):
            pp, pl = pdata.pack_samples(xs, 64, max_rows=max_rows)
            jp, jl = jdata.pack_samples(xs, 64, max_rows=max_rows)
            assert [id(x) for x in pl] == [id(x) for x in jl]
            assert len(pp) == len(jp)
            for a, b in zip(pp, jp):
                assert a.keys() == b.keys()
                for key in a:
                    if isinstance(a[key], np.ndarray):
                        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
                    else:
                        assert a[key] == b[key], key


def test_collate_packed_rows_matches_jax():
    cfg, jcfg = tiny_config(), jax_tiny_config()
    xs = samples(3, [24, 40, 18, 30])
    packed, _ = jdata.pack_samples(xs, 64)
    assert_batch_equal(pdata.collate_packed_rows(packed, cfg, accum=3, device="cpu"),
                       jdata.collate_packed_rows(packed, jcfg, accum=3))


def test_text_only_window_has_no_vision():
    batch = pdata.collate(samples(4, [20, 30], with_video=False), tiny_config(), device="cpu")
    assert batch.vision_patches is None and batch.attention_mask.dtype == torch.bool


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total,ratio", [(10, 0.03), (3, 0.03), (100, 0.1)])
def test_lr_schedule_matches_optax(total, ratio):
    pc = pstep.TrainConfig(learning_rate=2e-5, total_steps=total, warmup_ratio=ratio)
    jc = jstep.TrainConfig(learning_rate=2e-5, total_steps=total, warmup_ratio=ratio)
    ps, js = pstep.lr_schedule(pc), jstep.lr_schedule(jc)
    assert ps(0) == 0.0
    for count in range(total + 3):
        np.testing.assert_allclose(ps(count), float(js(count)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("clip,wd", [(True, 0.0), (False, 0.1)])
def test_adamw_update_matches_optax(clip, wd):
    """Three updates of the port's AdamW against optax's chain on the same
    params and grads: clipping triggered or not, with weight decay."""
    rng = np.random.RandomState(5)
    params = {"a": rng.randn(7, 5).astype(np.float32), "b": rng.randn(11).astype(np.float32)}
    scale = 3.0 if clip else 0.01
    grads = [{k: (rng.randn(*v.shape) * scale).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    pc = pstep.TrainConfig(learning_rate=1e-2, total_steps=10, weight_decay=wd)
    jc = jstep.TrainConfig(learning_rate=1e-2, total_steps=10, weight_decay=wd)
    jopt = jstep.make_optimizer(jc)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    popt = pstep.make_optimizer(pc)
    pp = {k: T(v.copy()) for k, v in params.items()}
    ps = popt.init(pp)
    for g in grads:
        upd, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        ps = popt.update({k: T(v) for k, v in g.items()}, ps, pp)
        for k in params:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-8)
    assert ps["count"] == 3
    np.testing.assert_allclose(ps["mu"]["a"].numpy(), np.asarray(js[1][0].mu["a"]), rtol=1e-5)
    np.testing.assert_allclose(ps["nu"]["b"].numpy(), np.asarray(js[1][0].nu["b"]), rtol=1e-5)


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_adamw_bf16_params_match_optax(mu_dtype):
    """bf16 params with fp32 gradients (the accumulators of a bf16 step),
    three updates against optax: the params, and the moments' dtypes and
    values. optax's first update promotes its param-dtype zeros to fp32 and
    keeps nu so; mu too, unless ``mu_dtype`` casts it back."""
    rng = np.random.RandomState(6)
    params = {"a": rng.randn(9, 6).astype(np.float32), "b": rng.randn(13).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.05).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    kw = dict(learning_rate=1e-2, total_steps=10, weight_decay=0.1)
    jc = jstep.TrainConfig(**kw, adam_mu_dtype=None if mu_dtype is None else jnp.bfloat16)
    pc = pstep.TrainConfig(**kw, adam_mu_dtype=None if mu_dtype is None else torch.bfloat16)
    jopt, popt = jstep.make_optimizer(jc), pstep.make_optimizer(pc)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    pp = {k: T(v).bfloat16() for k, v in params.items()}
    js, ps = jopt.init(jp), popt.init(pp)
    for g in grads:
        upd, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        ps = popt.update({k: T(v) for k, v in g.items()}, ps, pp)
    mu_t = torch.float32 if mu_dtype is None else torch.bfloat16
    for k in params:
        assert pp[k].dtype == torch.bfloat16 and jp[k].dtype == jnp.bfloat16
        np.testing.assert_array_equal(pp[k].float().numpy(), np.asarray(jp[k], np.float32))
        jmu, jnu = js[1][0].mu[k], js[1][0].nu[k]
        assert str(jmu.dtype) == str(mu_t)[6:] and jnu.dtype == jnp.float32
        assert ps["mu"][k].dtype == mu_t and ps["nu"][k].dtype == torch.float32
        np.testing.assert_allclose(ps["mu"][k].float().numpy(), np.asarray(jmu, np.float32),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(ps["nu"][k].numpy(), np.asarray(jnu), rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# the whole step against JAX make_train_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,ce_impl,bucket", [
    ("bool", "scan", None), ("bool", "fused", None),
    ("packed", "scan", None), ("packed", "fused", 48),
])
def test_train_step_matches_jax(jax_params, kind, ce_impl, bucket):
    """3 steps of the port's step against JAX's on the same weights and
    batch: per-step losses, the updated params, and the frozen ViT."""
    cfg, jcfg = tiny_config(), jax_tiny_config()
    xs = samples(6, [30, 44, 26, 36])
    if kind == "bool":
        jb = jdata.collate(xs[:2], jcfg)
        pb = pdata.collate(xs[:2], cfg, device="cpu")
    else:
        packed, _ = jdata.pack_samples(xs, 80)
        jb = jdata.collate_packed_rows(packed, jcfg, accum=2)
        pb = pdata.collate_packed_rows(packed, cfg, accum=2, device="cpu")
    assert pb.accum == 2
    kw = dict(learning_rate=1e-4, total_steps=10, ce_chunk_size=16, ce_impl=ce_impl,
              ce_sup_bucket=bucket, adam_eps=1e-6)
    jc, pc = jstep.TrainConfig(**kw), pstep.TrainConfig(**kw)
    jopt = jstep.make_optimizer(jc)
    jstate = jopt.init(jstep.split_frozen(jax_params, jc.freeze_modules)[0])
    jfn = jax.jit(jstep.make_train_step(jcfg, jc, jopt))
    model = port_model(jax_params)
    visual = {n: p.clone() for n, p in model.visual.named_parameters()}
    popt = pstep.make_optimizer(pc)
    pstate = popt.init(pstep.split_frozen(model, pc.freeze_modules)[0])
    pfn = pstep.make_train_step(cfg, pc, popt)
    params = jax_params
    for _ in range(3):
        params, jstate, jm_ = jfn(params, jstate, jb)
        model, pstate, pm_ = pfn(model, pstate, pb)
        np.testing.assert_allclose(float(pm_["loss"]), float(jm_["loss"]), rtol=1e-5)
        assert int(pm_["tokens"]) == int(jm_["tokens"]) > 0
        assert int(pm_["ce_dropped"]) == int(jm_["ce_dropped"])
    assert_params_equal(model, params)
    for n, p in model.visual.named_parameters():
        assert torch.equal(p, visual[n]), n


@pytest.mark.parametrize("ce_impl", ["scan", "fused"])
def test_loss_fn_grads_match_jax(jax_params, ce_impl):
    """One packed micro-batch with video: the summed loss and every
    trainable gradient against JAX ``loss_fn`` under ``value_and_grad``."""
    cfg, jcfg = tiny_config(), jax_tiny_config()
    packed, _ = jdata.pack_samples(samples(6, [30, 44, 26, 36]), 80)
    jb = jdata.collate_packed_rows(packed, jcfg, accum=2)
    pb = pdata.collate_packed_rows(packed, cfg, accum=2, device="cpu")
    kw = dict(ce_chunk_size=16, ce_impl=ce_impl)
    jc, pc = jstep.TrainConfig(**kw), pstep.TrainConfig(**kw)
    trainable, frozen = jstep.split_frozen(jax_params, jc.freeze_modules)
    micro = jax.tree_util.tree_map(lambda x: x[0], jb)
    (jloss, (jcount, _)), jg = jax.value_and_grad(
        lambda t: jstep.loss_fn({**frozen, **t}, jcfg, jc, micro), has_aux=True)(trainable)
    model = port_model(jax_params)
    pstep.split_frozen(model, pc.freeze_modules)
    loss, (count, dropped) = pstep.loss_fn(model, cfg, pc, pb.micro(0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    assert int(count) == int(jcount) and int(dropped) == 0
    ref = dict(port_model({**frozen, **jg}).named_parameters())
    for n, p in model.named_parameters():
        if n.startswith("text."):
            r = ref[n].detach()
            assert (p.grad - r).abs().max() <= 1e-5 * r.abs().max(), n
        else:
            assert p.grad is None, n


def test_first_update_has_learning_rate_zero(jax_params):
    cfg = tiny_config()
    model = port_model(jax_params)
    before = {n: p.clone() for n, p in model.named_parameters()}
    tcfg = pstep.TrainConfig(learning_rate=1e-3, total_steps=10, ce_chunk_size=16)
    opt = pstep.make_optimizer(tcfg)
    state = opt.init(pstep.split_frozen(model, tcfg.freeze_modules)[0])
    batch = pdata.collate(samples(7, [30, 20]), cfg, device="cpu")
    step = pstep.make_train_step(cfg, tcfg, opt)
    model, state, _ = step(model, state, batch)
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    model, state, _ = step(model, state, batch)
    assert not torch.equal(model.text.embed.weight, before["text.embed.weight"])
    assert torch.equal(model.visual.patch_embed.weight, before["visual.patch_embed.weight"])


@pytest.mark.parametrize("kind", ["bool", "packed"])
def test_train_step_frees_each_grad_during_the_backward(jax_params, monkeypatch, kind):
    """``make_train_step`` takes each trainable parameter's ``.grad`` into
    its fp32 accumulator as autograd completes it: right after every
    micro-step's backward no parameter holds a ``.grad`` (where the
    accumulation after ``backward()``, written out below, leaves them all);
    two steps give that accumulation's losses and parameters bit for bit;
    and no hook is left on a parameter after a step."""
    cfg = tiny_config()
    xs = samples(6, [30, 44, 26, 36])
    if kind == "bool":
        batch = pdata.collate(xs[:2], cfg, device="cpu")
    else:
        batch = pdata.collate_packed_rows(jdata.pack_samples(xs, 80)[0], cfg, accum=2,
                                          device="cpu")
    assert batch.accum == 2
    tcfg = pstep.TrainConfig(learning_rate=1e-3, total_steps=10, ce_chunk_size=16)
    opt = pstep.make_optimizer(tcfg)

    def after_backward_step(model, opt_state, batch):
        trainable, _ = pstep.split_frozen(model, tcfg.freeze_modules)
        acc = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in trainable.items()}
        loss_sum, count_sum = torch.zeros(()), torch.zeros((), dtype=torch.int64)
        for i in range(batch.accum):
            for p in trainable.values():
                p.grad = None
            loss, (count, _) = pstep.loss_fn(model, cfg, tcfg, batch.micro(i))
            loss.backward()
            for n, p in trainable.items():
                if p.grad is not None:
                    acc[n].add_(p.grad)
                    p.grad = None
            loss_sum += loss.detach()
            count_sum += count
        denom = torch.clamp(count_sum, min=1).float()
        for g in acc.values():
            g.div_(denom)
        return model, opt.update(acc, opt_state, trainable), {"loss": loss_sum / denom}

    held, real_backward = [], torch.Tensor.backward
    watched = []

    def backward(self, *args, **kwargs):
        real_backward(self, *args, **kwargs)
        held.append(sum(p.grad is not None for p in watched[-1].parameters()))

    monkeypatch.setattr(torch.Tensor, "backward", backward)
    runs = {}
    for name, step in (("hooked", pstep.make_train_step(cfg, tcfg, opt)),
                       ("after_backward", after_backward_step)):
        model = port_model(jax_params)
        watched.append(model)
        state = opt.init(pstep.split_frozen(model, tcfg.freeze_modules)[0])
        held.clear()
        losses = []
        for _ in range(2):
            model, state, metrics = step(model, state, batch)
            losses.append(metrics["loss"])
            assert not any(getattr(p, "_post_accumulate_grad_hooks", None)
                           for p in model.parameters())
        runs[name] = (model, losses, list(held))
    hooked, ref = runs["hooked"], runs["after_backward"]
    assert hooked[2] == [0] * 4
    assert len(ref[2]) == 4 and min(ref[2]) > 0      # the count sees a .grad left alive
    assert all(torch.equal(a, b) for a, b in zip(hooked[1], ref[1]))
    ref_params = dict(ref[0].named_parameters())
    for n, p in hooked[0].named_parameters():
        assert torch.equal(p, ref_params[n]), n
    assert not torch.equal(hooked[0].text.embed.weight,       # step 2 moved the weights
                           port_model(jax_params).text.embed.weight)


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def trainer(jax_params, tmp_path, dataset, **run_kw):
    cfg = tiny_config()
    tcfg = pstep.TrainConfig(learning_rate=1e-3, total_steps=20, ce_chunk_size=16)
    run = TrainerConfig(output_dir=str(tmp_path), loader_workers=1, log_steps=1,
                        **{"accum_steps": 2, "save_steps": None, **run_kw})
    return Trainer(port_model(jax_params), cfg, tcfg, run, dataset)


def test_trainer_loss_decreases(jax_params, tmp_path):
    data = samples(8, [30, 34])
    tr = trainer(jax_params, tmp_path, data, total_steps=6)
    losses = []
    tr.train(on_step=lambda step, batch, m: losses.append(float(m["loss"])))
    assert len(losses) == 6 and losses[-1] < losses[1], losses
    log = (tmp_path / "log.jsonl").read_text().splitlines()
    assert len(log) == 6


def test_trainer_checkpoint_then_resume(jax_params, tmp_path):
    data = samples(9, [30, 34, 28])
    tr = trainer(jax_params, tmp_path, data, total_steps=2, save_steps=1)
    tr.train()
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "2"]
    other = jm.init_params(jax_tiny_config(), jax.random.PRNGKey(1))
    tr2 = trainer(other, tmp_path, data, total_steps=3, save_steps=1)
    assert tr2.step == 2 and tr2.opt_state["count"] == 2
    for (n, a), b in zip(tr.model.named_parameters(), tr2.model.parameters()):
        assert torch.equal(a, b), n
    for n in tr.opt_state["mu"]:
        assert torch.equal(tr.opt_state["nu"][n], tr2.opt_state["nu"][n]), n
    tr2.train()
    assert tr2.step == 3 and (tmp_path / "ckpt" / "3" / "state.pt").exists()


def test_trainer_packing_carries_leftovers(jax_params, tmp_path):
    data = samples(10, [30, 40, 20, 50, 26])
    tr = trainer(jax_params, tmp_path, data, total_steps=1, pack_seq=100)
    batch = tr._load_batch(random.Random(0))
    assert batch.accum == 2 and batch.attention_mask.dtype == torch.int32
    assert int(batch.attention_mask.max()) >= 2          # a row packs 2+ samples
    # rows of 64 hold one of these samples each: with three samples already
    # buffered, the window takes two and carries the third (and the fetched
    # ones) to the next window, which starts with it
    data = samples(11, [40, 44, 48, 36])
    tr = trainer(jax_params, tmp_path / "carry", data, total_steps=1, pack_seq=64)
    tr._pack_buf = data[:3]
    batch = tr._load_batch(random.Random(0))
    assert batch.accum == 2
    for row, x in enumerate(data[:2]):
        np.testing.assert_array_equal(batch.input_ids[row, 0, :x["input_ids"].shape[1]].numpy(),
                                      x["input_ids"][0])
    assert tr._pack_buf[0] is data[2] and len(tr._pack_buf) == 3
    batch = tr._load_batch(random.Random(1))
    np.testing.assert_array_equal(batch.input_ids[0, 0, :48].numpy(), data[2]["input_ids"][0])


@pytest.mark.parametrize("kind", ["packed", "bool"])
def test_window_flops_counts_each_segment(kind):
    """Model FLOPs of a window: each sample's own causal span (not one span
    per packed row), plus the frozen ViT over each micro-batch's patches."""
    from livecc_tpu_torch.tools.train_session import window_flops

    cfg = tiny_config()
    xs = samples(6, [30, 44, 26, 36])
    if kind == "packed":
        packed, _ = pdata.pack_samples(xs, 80)
        batch = pdata.collate_packed_rows(packed, cfg, accum=2, device="cpu")
        assert int(batch.attention_mask.max()) == 2
    else:
        batch = pdata.collate(xs[:2], cfg, device="cpu")
    lens = [x["input_ids"].shape[1] for x in (xs if kind == "packed" else xs[:2])]
    vit = sum(pflops.vit_forward_flops(cfg.vision, int((batch.vision_seg_ids[a] >= 0).sum()),
                                       batch.vision_group) for a in range(batch.accum))
    flops, tokens = window_flops(cfg, batch)
    assert tokens == sum(lens)
    assert flops == sum(pflops.train_step_flops(cfg, n, n) for n in lens) + vit
    if kind == "packed":      # one span per row would count the cross-sample pairs
        rows = (lens[0] + lens[1], lens[2] + lens[3])
        assert flops < sum(pflops.train_step_flops(cfg, n, n) for n in rows) + vit


def test_tiny_train_losses_on_the_cpu():
    """The tiny run that the card repeats with its kernels: the first update
    (learning rate 0) leaves the second loss equal to the first, the next
    lowers it."""
    from livecc_tpu_torch.tools.train_session import tiny_train_losses

    losses = tiny_train_losses("cpu")
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[1] == losses[0] and losses[2] < losses[1]


def test_train_step_flops_copy():
    from livecc_tpu.utils import flops as jflops

    from livecc_tpu.core.config import ModelConfig as JaxModelConfig
    from livecc_tpu_torch.core.config import ModelConfig

    for args in ((8192, 3000, 6528, 544, 2), (256, 100, 0, None, 1)):
        assert pflops.train_step_flops(ModelConfig(), *args) == \
            jflops.train_step_flops(JaxModelConfig(), *args)


"""The port's memory planner and calibration against JAX's (CPU).

``livecc_tpu_torch/parallel/memory.py`` against ``livecc_tpu/parallel/
memory.py``: parameter counts and a rank's weight bytes from the port's
split rule (a split tensor counted whole must fail), KV bytes against real
caches, serving plans field for field, training plans from the port's
ZeRO-2 layout against JAX's and against a real ``Zero2`` on one process,
the latency projections and the streaming horizon on the same costs, the
measured rows' provenance, and ``utils/calibrate.py``'s chain and
``tools/layer_costs.py``'s differencing against JAX's arithmetic
(``bench.py:bench_7b_slice`` / ``bench_7b_train_slice``).
"""

import dataclasses
import re
import types

import pytest
import torch

from livecc_tpu.core import config as jcfg
from livecc_tpu.parallel import memory as jm
from livecc_tpu.utils import calibrate as jcal
from tools.exp_7b_train_slice import flop_model_per_layer as jax_flop_model

from livecc_tpu_torch.core import config as pcfg
from livecc_tpu_torch.core.mesh import Mesh
from livecc_tpu_torch.models.qwen2_vl.model import init_params
from livecc_tpu_torch.models.qwen2_vl.text import KVCache
from livecc_tpu_torch.parallel import memory as pm
from livecc_tpu_torch.parallel.sharding import GRAD_BUCKET, Zero2, shard_params
from livecc_tpu_torch.tools import layer_costs
from livecc_tpu_torch.train.step import split_frozen
from livecc_tpu_torch.utils import calibrate as pcal
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PRESETS = {"tiny": "tiny_config", "2b": "qwen2_vl_2b", "7b": "qwen2_vl_7b", "72b": "qwen2_vl_72b"}


def configs(name):
    """(JAX config, port config) of a preset."""
    if name == "tiny":
        return jcfg.tiny_config(), pcfg.tiny_config()
    return (getattr(jcfg.ModelConfig, PRESETS[name])(),
            getattr(pcfg.ModelConfig, PRESETS[name])())


WEIGHT_CASES = [("tiny", 1), ("tiny", 2), ("2b", 1), ("2b", 2), ("7b", 1), ("7b", 2),
                ("7b", 4), ("72b", 2), ("72b", 4), ("72b", 8)]


@pytest.mark.parametrize("name,tp", WEIGHT_CASES)
def test_weights_per_rank_match_jax(name, tp):
    jc, pc = configs(name)
    assert pm.count_params(pc) == jm.count_params(jc)
    for dtype_bytes in (2, 1):
        assert (pm.weights_bytes_per_chip(pc, tp, dtype_bytes)
                == jm.weights_bytes_per_chip(jc, tp, dtype_bytes))


def test_a_split_tensor_counted_whole_fails(monkeypatch):
    """The planted fault: q_proj's weight counted whole on every rank."""
    jc, pc = configs("7b")
    right = pm.split_dim
    monkeypatch.setattr(pm, "split_dim",
                        lambda name: None if name.endswith("q_proj.weight") else right(name))
    assert pm.weights_bytes_per_chip(pc, 1) == jm.weights_bytes_per_chip(jc, 1)
    for tp in (2, 4):
        assert pm.weights_bytes_per_chip(pc, tp) != jm.weights_bytes_per_chip(jc, tp)


@pytest.mark.parametrize("cache_len", [8192, 32768])
@pytest.mark.parametrize("dtype_bytes", [2, 1])
def test_kv_bytes_match_jax(cache_len, dtype_bytes):
    jc, pc = configs("7b")
    for tp in range(1, 29):
        assert (pm.kv_bytes_per_chip(pc, tp, cache_len, dtype_bytes)
                == jm.kv_bytes_per_chip(jc, tp, cache_len, dtype_bytes))


@pytest.mark.parametrize("tp", [1, 2])
def test_kv_plan_is_a_real_cache(tp):
    """bf16: the plan is the cache's bytes; int8: the plan plus the bf16
    scales (2 * L * Hk * S * 2 bytes a stream, not counted, as in JAX)."""
    _, pc = configs("tiny")
    t, batch, length = pc.text, 3, 96
    rank = None if tp == 1 else types.SimpleNamespace(size=tp)
    bf16 = KVCache.zeros(t, batch, length, torch.bfloat16, "cpu", rank)
    assert bf16.k.nbytes + bf16.v.nbytes == batch * pm.kv_bytes_per_chip(pc, tp, length)
    q = KVCache.zeros(t, batch, length, torch.int8, "cpu", rank)
    scales = batch * 2 * t.num_hidden_layers * (t.num_key_value_heads // tp) * length * 2
    assert q.k_scale.nbytes + q.v_scale.nbytes == scales
    assert (q.k.nbytes + q.v.nbytes + q.k_scale.nbytes + q.v_scale.nbytes
            == batch * pm.kv_bytes_per_chip(pc, tp, length, 1) + scales)


SERVING_CASES = [  # tests/test_memory_plan.py's configurations
    ("7b", dict(n_model=1, streams=1, cache_len=32768)),
    ("7b", dict(n_model=4, streams=8, cache_len=32768)),
    ("7b", dict(n_model=4, streams=24, cache_len=32768, kv_dtype_bytes=1)),
    ("7b", dict(n_model=2, streams=8, cache_len=32768, param_dtype_bytes=1, kv_dtype_bytes=1)),
    ("7b", dict(n_model=2, streams=8, cache_len=32768)),
    ("2b", dict(n_model=1, streams=8, cache_len=8192)),
    ("tiny", dict(n_model=2, streams=4, cache_len=256)),
]


@pytest.mark.parametrize("hbm_gib", [16.0, 79.65])
@pytest.mark.parametrize("name,kw", SERVING_CASES)
def test_serving_plan_matches_jax(name, kw, hbm_gib):
    jc, pc = configs(name)
    mine = pm.serving_plan(pc, hbm_gib=hbm_gib, **kw)
    ref = jm.serving_plan(jc, hbm_gib=hbm_gib, **kw)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert (mine.total_bytes, mine.fits, mine.describe()) == (ref.total_bytes, ref.fits,
                                                            ref.describe())


def test_tp_must_divide_heads_and_no_card_raises():
    jc, pc = configs("7b")
    with pytest.raises(ValueError) as ours:
        pm.serving_plan(pc, n_model=8, streams=1, hbm_gib=16.0)
    with pytest.raises(ValueError) as theirs:
        jm.serving_plan(jc, n_model=8, streams=1)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pm.serving_plan(pc, n_model=1, streams=1)          # hbm_gib=None reads the card


TRAIN_CASES = [("2b", 8, 2), ("2b", 1, 4), ("7b", 8, 4), ("7b", 2, 2), ("tiny", 4, 4)]


@pytest.mark.parametrize("name,n_data,mu", TRAIN_CASES)
def test_training_plan_against_jax(name, n_data, mu):
    """At TP = 1: weights, moments and the fp32 gradient partition JAX's up
    to the flat buffer's padding (< n_data elements); grads also count
    ``Zero2``'s staging bucket where n_data > 1 (the 7B at 8 x 1: 3.55 GiB
    of partition, not the whole 28.37)."""
    jc, pc = configs(name)
    mine = pm.training_plan(pc, n_data=n_data, mu_dtype_bytes=mu, hbm_gib=79.65)
    ref = jm.training_plan(jc, n_data=n_data, mu_dtype_bytes=mu, hbm_gib=79.65)
    assert mine.trainable_params == ref.trainable_params
    pad = n_data - 1
    assert 0 <= mine.weights_bytes - ref.weights_bytes <= 2 * pad
    assert 0 <= mine.adam_m_bytes - ref.adam_m_bytes <= mu
    assert 0 <= mine.adam_v_bytes - ref.adam_v_bytes <= 4
    part = -(-mine.trainable_params // n_data)
    bucket = 0 if n_data == 1 else min(GRAD_BUCKET, part)
    assert mine.grads_bytes == 4 * (part + bucket)
    assert 0 <= 4 * part - ref.grads_bytes <= 4


@pytest.mark.parametrize("n_data,n_model", [(1, 1), (2, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("mu_dtype", [None, torch.bfloat16])
def test_training_plan_is_a_real_zero2(n_data, n_model, mu_dtype):
    """The plan's four terms are the bytes of a ``Zero2`` built on one
    process (no process group) over rank 0's shard of a bf16 tiny model,
    with its ``init_state``: grads its fp32 partition plus its bucket."""
    _, pc = configs("tiny")
    model = init_params(pc, torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    mesh = Mesh(n_data, n_model, 0, None, None, torch.device("cpu"))
    shard_params(model, pc, mesh, training=True)
    trainable, frozen = split_frozen(model, ("visual",))
    zero = Zero2(trainable, mesh)
    state = zero.init_state(mu_dtype)
    plan = pm.training_plan(pc, n_data=n_data, n_model=n_model, hbm_gib=16.0,
                            mu_dtype_bytes=2 if mu_dtype else 4)
    assert plan.weights_bytes == sum(p.nbytes for p in frozen.values()) + zero.flat.nbytes
    assert zero.grad.numel() == zero.part == zero.flat.numel() // n_data
    assert zero.bucket.numel() == (0 if n_data == 1 else zero.part)       # tiny < GRAD_BUCKET
    assert plan.grads_bytes == zero.grad.nbytes + zero.bucket.nbytes
    assert (plan.adam_m_bytes, plan.adam_v_bytes) == (state["mu"].nbytes, state["nu"].nbytes)


def as_port(row):
    """A JAX measured row in the port's dataclass (this test's only use of them)."""
    kind = pm.MeasuredLayerCosts if isinstance(row, jm.MeasuredLayerCosts) else \
        pm.MeasuredTrainCosts
    return kind(**dataclasses.asdict(row))


def close_fields(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k, v in da.items():
        if isinstance(v, float):
            assert abs(v - db[k]) < 1e-9, k
        else:
            assert v == db[k], k


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_serving_latency_matches_jax(batch, tp, monkeypatch):
    jc, pc = configs("7b")
    for row in (*jm.MEASURED_7B_WIDTH_SESSIONS, jm.MEASURED_7B_WIDTH):
        ours = pm.serving_latency(pc, as_port(row), n_model=tp, batch=batch,
                                  link_allreduce_ms=0.005)
        ref = jm.serving_latency(jc, row, n_model=tp, batch=batch, ici_allreduce_ms=0.005)
        close_fields(ours, ref)
        assert ours.chunk_ms == pytest.approx(ref.chunk_ms, abs=1e-9)
    monkeypatch.setattr(pm, "MEASURED_7B_WIDTH_SESSIONS",
                        tuple(as_port(r) for r in jm.MEASURED_7B_WIDTH_SESSIONS))
    monkeypatch.setattr(pm, "nvlink_allreduce_ms", lambda nbytes, n: 0.005)  # JAX's default
    for ours, ref in zip(pm.serving_latency_band(pc, n_model=tp, batch=batch),
                         jm.serving_latency_band(jc, n_model=tp, batch=batch)):
        close_fields(ours, ref)


@pytest.mark.parametrize("n_data,n_model", [(1, 1), (1, 4), (2, 1), (2, 4)])
def test_training_latency_matches_jax(n_data, n_model):
    jc, pc = configs("7b")
    for row in (*jm.MEASURED_7B_TRAIN_SESSIONS, jm.MEASURED_7B_TRAIN):
        ours = pm.training_latency(pc, as_port(row), n_data=n_data, n_model=n_model,
                                   link_algo_gbps=90.0)
        ref = jm.training_latency(jc, row, n_data=n_data, n_model=n_model, ici_algo_gbps=90.0)
        close_fields(ours, ref)
        assert ours.tokens_per_s == pytest.approx(ref.tokens_per_s, rel=1e-12)


@pytest.mark.parametrize("grid", [(1, 22, 40), (1, 16, 34), (2, 8, 8)])
def test_streaming_horizon_matches_jax(grid):
    assert pm.chunk_tokens(grid) == jm.chunk_tokens(grid)
    for kw in (dict(cache_len=16384), dict(cache_len=16384, compact_keep=8192),
               dict(cache_len=8192, start_len=512, chunks_per_second=2.0,
                    decode_tokens_per_chunk=8, compact_keep=16000)):
        ours, ref = pm.streaming_horizon(grid, **kw), jm.streaming_horizon(grid, **kw)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert (ours.seconds_to_exhaustion, ours.unbounded, ours.seconds_between_compactions) \
            == (ref.seconds_to_exhaustion, ref.unbounded, ref.seconds_between_compactions)


def test_measured_rows_are_the_cards():
    """Every row names an H100 and its power limit; none is a v5e row; the
    envelopes are the per-field extremes of the rows, as JAX builds them."""
    numbers = lambda r: tuple(v for k, v in dataclasses.asdict(r).items() if k != "provenance")
    for ours, theirs in ((pm.MEASURED_7B_WIDTH_SESSIONS, jm.MEASURED_7B_WIDTH_SESSIONS),
                         (pm.MEASURED_7B_TRAIN_SESSIONS, jm.MEASURED_7B_TRAIN_SESSIONS)):
        assert len(ours) >= 2
        for row in ours:
            assert "NVIDIA H100" in row.provenance
            assert re.search(r"\d+\.\d+ W", row.provenance), row.provenance
            assert "PR 22" in row.provenance
            assert numbers(row) not in {numbers(r) for r in theirs}
    rows = pm.MEASURED_7B_WIDTH_SESSIONS
    assert pm.MEASURED_7B_WIDTH.per_layer_decode_b1_ms == max(r.per_layer_decode_b1_ms
                                                              for r in rows)
    assert pm.MEASURED_7B_WIDTH.overhead_ms == max(r.overhead_ms for r in rows)
    rows = pm.MEASURED_7B_TRAIN_SESSIONS
    assert pm.MEASURED_7B_TRAIN.per_layer_step_ms == max(r.per_layer_step_ms for r in rows)
    assert pm.MEASURED_7B_TRAIN.vs_calibrated == min(r.vs_calibrated for r in rows)
    assert not hasattr(pm, "V5E_HBM_GIB")


def test_calibration_chain_and_keys():
    n = 256
    ones = torch.ones((n, n), dtype=torch.bfloat16)
    assert float(pcal.matmul_chain(ones, ones)) == n * n
    out = pcal.calibrate_matmul("cpu", n=n)
    assert set(out) == {"wall_s", "achieved_tflops"}
    assert (pcal.CAL_N, pcal.CAL_CHAIN, pcal.CAL_FLOPS) == (jcal.CAL_N, jcal.CAL_CHAIN,
                                                           jcal.CAL_FLOPS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pcal.calibrate_matmul()


def test_costs_from_depths_is_benchs_arithmetic():
    """``bench.py:381-387`` and ``:424-443`` on given walls (ms)."""
    meas = {2: {"d1": 4.1, "d8": 5.3, "p256": 2.9}, 4: {"d1": 4.7, "d8": 6.1, "p256": 3.8}}
    costs = layer_costs.costs_from_depths(meas, "walls")
    per_b1 = (meas[4]["d1"] - meas[2]["d1"]) / 2
    head_b1 = meas[2]["d1"] - 2 * per_b1
    assert costs.per_layer_decode_b1_ms == pytest.approx(per_b1, abs=1e-12)
    assert costs.per_layer_decode_b8_ms == pytest.approx((6.1 - 5.3) / 2, abs=1e-12)
    assert costs.per_layer_prefill256_ms == pytest.approx((3.8 - 2.9) / 2, abs=1e-12)
    assert costs.decode_remainder_ms == pytest.approx(head_b1, abs=1e-12)
    assert costs.lm_head_ms == pytest.approx(152064 * 3584 * 2 / 3.35e12 * 1e3, rel=1e-12)
    full = pcfg.ModelConfig.qwen2_vl_7b()
    proj = pm.serving_latency(full, costs, n_model=1)
    assert proj.decode_ms_per_token == pytest.approx(head_b1 + 28 * per_b1, abs=1e-12)

    lo, hi, cal = 320.0, 440.0, 650.0
    tc = layer_costs.train_costs_from_depths({1: lo, 3: hi}, cal, "walls")
    per_s = (hi - lo) / 2 / 1e3
    fl = jax_flop_model(jcfg.ModelConfig.qwen2_vl_7b().text, 8192)
    assert layer_costs.flop_model_per_layer(full.text, 8192) == fl
    assert tc.per_layer_step_ms == pytest.approx(per_s * 1e3, abs=1e-12)
    assert tc.remainder_ms == pytest.approx((lo / 1e3 - per_s) * 1e3, abs=1e-9)
    assert tc.measured_tflops == pytest.approx(fl / per_s / 1e12, rel=1e-12)
    assert tc.vs_calibrated == pytest.approx(fl / per_s / 1e12 / cal, rel=1e-12)
    assert pm.training_latency(full, tc).step_s == pytest.approx(
        (lo / 1e3 - per_s) + 28 * per_s, abs=1e-12)


def test_parallel_exports_the_plan():
    import livecc_tpu_torch.parallel as parallel

    assert (parallel.ServingPlan, parallel.count_params, parallel.serving_plan) == (
        pm.ServingPlan, pm.count_params, pm.serving_plan)

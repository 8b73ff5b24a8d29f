"""Serving and training memory plans, and latency projections, for one card
or a (data, model) mesh of them.

Port of ``livecc_tpu/parallel/memory.py``: checked arithmetic for the
operator's two questions, how many streams fit on a card and at what TP
degree, and how long a full-depth step takes from measured per-layer costs.
The names and the arithmetic are JAX's, with three deliberate differences:

  * **Shapes come from the port.** ``param_shapes`` builds ``Qwen2VL`` on
    the meta device (nothing is allocated; JAX's ``jax.eval_shape`` over
    ``init_params``), and the bytes a model rank holds come from the rule
    ``shard_params`` slices by (``parallel/sharding.py:split_dim``, each
    split tensor ``shard_size(n, M)`` elements), so the plan cannot drift
    from what the card allocates (chip_smoke ``memory_plan`` holds it to
    the bytes there).
  * **Training bytes follow the port's ZeRO-2 layout**
    (``parallel/sharding.py:Zero2``), not JAX's sharded leaves: a model
    rank's trainable shard in one flat buffer padded to a multiple of
    ``n_data``, the fp32 gradient and AdamW's moments over the rank's
    partition only, and at ``n_data > 1`` the fp32 staging bucket the
    gradient is reduced through. See ``training_plan``.
  * **No TPU figure.** The card's memory is read from the card
    (``hbm_gib=None``); the measured rows are the H100's
    (``tools/layer_costs.py``); the lm-head term is the head's bytes over
    the H100's 3.35 TB/s; the link terms are NVLink estimates from the
    H100 SXM data sheet, not measured (the measuring machine has one card).

Every plan is a memory bound only: what fits, not what a pool can serve
in time (that is the tick's compute, ``serving_latency``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.parallel.pipeline import stage_layers
from livecc_tpu_torch.parallel.sharding import grad_bucket_elements, shard_size, split_dim
from livecc_tpu_torch.utils.device import device_for

GIB = 1024**3
# NVIDIA H100 SXM data sheet, at its 700 W power limit: HBM3 3.35 TB/s (PERF.md's
# bound formula) and NVLink 900 GB/s per GPU. The link figure is the sheet's,
# never measured (the measuring machine has one card).
HBM_BYTES_PER_S = 3.35e12
NVLINK_GBPS = 900.0


def _hbm_bytes(hbm_gib: Optional[float]) -> int:
    """``hbm_gib`` in bytes, or with None the card's memory as torch reports
    it (``total_memory``), raising without a card."""
    if hbm_gib is not None:
        return int(hbm_gib * GIB)
    dev = device_for("cuda", "the memory plan", " (pass hbm_gib to plan for a card not here)")
    return torch.cuda.get_device_properties(dev).total_memory


@functools.lru_cache(maxsize=16)
def param_shapes(cfg: ModelConfig) -> tuple[tuple[str, int], ...]:
    """(name, elements) of every model parameter, from a ``Qwen2VL`` built
    on the meta device (no allocation)."""
    from livecc_tpu_torch.models.qwen2_vl.model import Qwen2VL   # the model imports parallel/

    model = Qwen2VL(cfg, device="meta", dtype=torch.bfloat16)
    return tuple((name, p.numel()) for name, p in model.named_parameters())


def count_params(cfg: ModelConfig) -> int:
    return sum(n for _, n in param_shapes(cfg))


def _rank_elements(name: str, n: int, n_model: int) -> int:
    """Elements of parameter ``name`` on one model rank (``shard_params``)."""
    return n if split_dim(name) is None else shard_size(n, n_model)


def _stage_elements(name: str, n: int, own: range) -> int:
    """Elements of parameter ``name`` on the pipeline stage that owns the
    layers ``own`` (``parallel/pipeline.py:shard_params_pp``: every stage
    owns as many layers of one shape, and the rest is whole)."""
    if not name.startswith("text.layers."):
        return n
    return n if int(name.split(".")[2]) in own else 0


def weights_bytes_per_chip(cfg: ModelConfig, n_model: int, dtype_bytes: int = 2) -> int:
    """One model rank's parameter bytes under the port's split rule."""
    return sum(_rank_elements(name, n, n_model) for name, n in param_shapes(cfg)) * dtype_bytes


def kv_bytes_per_chip(cfg: ModelConfig, n_model: int, cache_len: int,
                      dtype_bytes: int = 2) -> int:
    """One stream's KV cache bytes on one card: [L, B, Hk, S, D], the Hk
    axis split down to at best one KV head a card (beyond that the cache
    replicates). An int8 cache also holds bf16 scales [L, B, Hk, 1, S]
    (2 * L * Hk * S * 2 bytes a stream), which this does not count, as
    JAX does not."""
    t = cfg.text
    heads_per_chip = max(-(-t.num_key_value_heads // n_model), 1)
    return t.num_hidden_layers * 2 * heads_per_chip * cache_len * t.head_dim * dtype_bytes


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """Device-memory budget for serving ``streams`` concurrent streams under TP."""

    cfg_name: str
    n_model: int
    streams: int
    cache_len: int
    param_count: int
    weights_bytes: int            # per card
    kv_bytes_per_stream: int      # per card
    activation_reserve_bytes: int
    hbm_bytes: int                # per card

    @property
    def total_bytes(self) -> int:
        return (self.weights_bytes + self.streams * self.kv_bytes_per_stream
                + self.activation_reserve_bytes)

    @property
    def headroom_bytes(self) -> int:
        return self.hbm_bytes - self.total_bytes

    @property
    def fits(self) -> bool:
        return self.headroom_bytes >= 0

    def describe(self) -> str:
        g = lambda n: f"{n / GIB:.2f} GiB"
        return (
            f"{self.cfg_name} TP={self.n_model} streams={self.streams} "
            f"cache={self.cache_len}: weights/chip {g(self.weights_bytes)} + "
            f"KV {g(self.streams * self.kv_bytes_per_stream)} + reserve "
            f"{g(self.activation_reserve_bytes)} = {g(self.total_bytes)} of "
            f"{g(self.hbm_bytes)} ({'fits' if self.fits else 'DOES NOT FIT'}, "
            f"headroom {g(self.headroom_bytes)})"
        )


def serving_plan(
    cfg: ModelConfig,
    *,
    n_model: int,
    streams: int,
    cache_len: int = 32768,
    param_dtype_bytes: int = 2,
    kv_dtype_bytes: int = 2,
    hbm_gib: Optional[float] = None,
    activation_reserve_gib: float = 1.0,
) -> ServingPlan:
    """Checked serving budget; ``hbm_gib=None`` reads the card's memory.
    Raises on a TP degree the head layout cannot honour."""
    t = cfg.text
    if t.num_attention_heads % n_model != 0:
        raise ValueError(
            f"TP={n_model} does not divide {t.num_attention_heads} attention heads"
        )
    return ServingPlan(
        cfg_name=cfg.name,
        n_model=n_model,
        streams=streams,
        cache_len=cache_len,
        param_count=count_params(cfg),
        weights_bytes=weights_bytes_per_chip(cfg, n_model, param_dtype_bytes),
        kv_bytes_per_stream=kv_bytes_per_chip(cfg, n_model, cache_len, kv_dtype_bytes),
        activation_reserve_bytes=int(activation_reserve_gib * GIB),
        hbm_bytes=_hbm_bytes(hbm_gib),
    )


# ---------------------------------------------------------------------------
# Training budget (ZeRO-2 over the data axis)
# ---------------------------------------------------------------------------

def trainable_param_shapes(cfg: ModelConfig, freeze_modules=("visual",)):
    """(name, elements) of the parameters ``train/step.py:split_frozen``
    trains (frozen by top-level module)."""
    return tuple((name, n) for name, n in param_shapes(cfg)
                 if name.split(".")[0] not in freeze_modules)


def _local_elements(cfg: ModelConfig, name: str, n: int, n_model: int, pipeline: bool) -> int:
    if pipeline:
        return _stage_elements(name, n, stage_layers(cfg, n_model, 0))
    return _rank_elements(name, n, n_model)


def _zero2_elements(cfg: ModelConfig, *, n_data: int, n_model: int = 1,
                    freeze_modules: tuple = ("visual",),
                    pipeline: bool = False) -> tuple[int, int]:
    """(flat, partition) elements of one rank's ``Zero2``: ``flat`` the
    padded buffer of the model rank's trainable shard (each split tensor
    counted exactly through ``split_dim``, or a pipeline stage's layers),
    ``partition`` one data rank's ``flat / n_data``."""
    local = sum(_local_elements(cfg, name, n, n_model, pipeline)
                for name, n in trainable_param_shapes(cfg, freeze_modules))
    part = shard_size(local, n_data)
    return part * n_data, part


@dataclasses.dataclass(frozen=True)
class TrainingPlan:
    """Per-card device-memory budget of one ZeRO-2(+TP) train step, as the
    port lays it out (``parallel/sharding.py:Zero2``):

      * ``weights_bytes``: the frozen parameters of the model rank plus the
        flat buffer of its trainable shard (the trainable parameters are
        views of it), so JAX's figure plus at most ``n_data - 1`` padding
        elements;
      * ``grads_bytes``: the fp32 gradient of the data rank's partition
        (``Zero2.grad``), JAX's figure (fp32 grads sharded 1 / n_data) up
        to the padding, plus at ``n_data > 1`` the fp32 staging bucket
        (``Zero2.bucket``, ``GRAD_BUCKET`` elements at most) through which
        each micro-step's gradients are reduced; the bf16 ``.grad`` of a
        parameter lives only until autograd completes it;
      * ``adam_m_bytes`` / ``adam_v_bytes``: the moments of the partition
        only (``Zero2.init_state``).

    At TP > 1 every term counts the rank's shard exactly (``split_dim``),
    where JAX divides the ZeRO bytes by the TP degree; with ``pipeline``
    the model axis holds stages, and every term counts one stage's."""

    cfg_name: str
    n_data: int
    n_model: int
    trainable_params: int
    weights_bytes: int            # frozen params + the flat trainable buffer, per card
    grads_bytes: int              # fp32 partition (+ the staging bucket at n_data > 1)
    adam_m_bytes: int             # first moment (mu dtype), the partition
    adam_v_bytes: int             # second moment fp32, the partition
    activation_reserve_bytes: int
    hbm_bytes: int
    pipeline: bool = False        # n_model counts pipeline stages, not TP shards

    @property
    def total_bytes(self) -> int:
        return (self.weights_bytes + self.grads_bytes + self.adam_m_bytes
                + self.adam_v_bytes + self.activation_reserve_bytes)

    @property
    def headroom_bytes(self) -> int:
        return self.hbm_bytes - self.total_bytes

    @property
    def fits(self) -> bool:
        return self.headroom_bytes >= 0

    def describe(self) -> str:
        g = lambda n: f"{n / GIB:.2f} GiB"
        return (
            f"{self.cfg_name} train DP={self.n_data} {'PP' if self.pipeline else 'TP'}="
            f"{self.n_model}: "
            f"weights/chip {g(self.weights_bytes)} + grads {g(self.grads_bytes)} "
            f"+ adam_m {g(self.adam_m_bytes)} + adam_v {g(self.adam_v_bytes)} "
            f"+ reserve {g(self.activation_reserve_bytes)} = {g(self.total_bytes)} "
            f"of {g(self.hbm_bytes)} ({'fits' if self.fits else 'DOES NOT FIT'}, "
            f"headroom {g(self.headroom_bytes)})"
        )


def training_plan(
    cfg: ModelConfig,
    *,
    n_data: int,
    n_model: int = 1,
    freeze_modules: tuple = ("visual",),
    param_dtype_bytes: int = 2,
    mu_dtype_bytes: int = 4,            # 2 with TrainConfig.adam_mu_dtype=bf16
    hbm_gib: Optional[float] = None,
    activation_reserve_gib: float = 2.0,
    pipeline: bool = False,             # the model axis holds pipeline stages, not TP shards
) -> TrainingPlan:
    """Checked ZeRO-2 training budget of one card (``TrainingPlan``).
    Frozen modules carry no gradients or moments (``split_frozen``). With
    ``pipeline`` the stages must divide the layers (``stage_layers``
    raises), else TP must divide the heads."""
    t = cfg.text
    if pipeline:
        stage_layers(cfg, n_model, 0)
    elif t.num_attention_heads % n_model != 0:
        raise ValueError(
            f"TP={n_model} does not divide {t.num_attention_heads} attention heads"
        )
    flat, part = _zero2_elements(cfg, n_data=n_data, n_model=n_model,
                                freeze_modules=freeze_modules, pipeline=pipeline)
    trainable = {name for name, _ in trainable_param_shapes(cfg, freeze_modules)}
    frozen = sum(_local_elements(cfg, name, n, n_model, pipeline) for name, n in param_shapes(cfg)
                 if name not in trainable)
    return TrainingPlan(
        cfg_name=cfg.name,
        n_data=n_data,
        n_model=n_model,
        trainable_params=sum(n for _, n in trainable_param_shapes(cfg, freeze_modules)),
        weights_bytes=(frozen + flat) * param_dtype_bytes,
        grads_bytes=(part + grad_bucket_elements(part, n_data)) * 4,
        adam_m_bytes=part * mu_dtype_bytes,
        adam_v_bytes=part * 4,
        activation_reserve_bytes=int(activation_reserve_gib * GIB),
        hbm_bytes=_hbm_bytes(hbm_gib),
        pipeline=pipeline,
    )


# ---------------------------------------------------------------------------
# Serving latency projection from measured per-layer costs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeasuredLayerCosts:
    """Per-layer serving costs measured on the card at the 7B's true width
    (``tools/layer_costs.py``): decode steps and a 256-token prefill at two
    depths of the width-exact model, differenced so every depth-independent
    term (the 152k-vocab head, embedding, sampling, launch glue) cancels.
    The depth-independent decode term splits into ``lm_head_ms``, the head's
    read, which shards 1 / TP under the vocab split, and ``overhead_ms``,
    the rest (sampling, repetition penalty, the step's glue), which does
    not. The prefill's depth-independent remainder is not carried, as in
    JAX: a chunk's prefill also runs the ViT, which the probe does not."""

    per_layer_decode_b1_ms: float
    per_layer_decode_b8_ms: float
    per_layer_prefill256_ms: float
    lm_head_ms: float              # depth-independent, TP-shardable head read
    overhead_ms: float             # depth-independent, does NOT shard with TP
    provenance: str

    @property
    def decode_remainder_ms(self) -> float:
        """Total depth-independent decode term."""
        return self.lm_head_ms + self.overhead_ms


def head_read_ms(cfg: ModelConfig) -> float:
    """The bf16 [vocab, hidden] head's bytes over the H100's HBM rate: a
    bound, not a measurement."""
    t = cfg.text
    return t.vocab_size * t.hidden_size * 2 / HBM_BYTES_PER_S * 1e3


# 152064 x 3584 bf16 = 1.09 GB at 3.35 TB/s: 0.325 ms, the same in every row
_LM_HEAD_BW_MS = head_read_ms(ModelConfig.qwen2_vl_7b())

# tools/layer_costs.py on the card, depths (2, 4), a bf16 cache of 8192 seated
# at 4096 — ONE ROW PER RUN (PERF.md, PR 22). The decode terms agree within
# 6% (B = 1) and 10% (B = 8) across the runs; the prefill term (single calls,
# host work included, the host bound) does not (1.41-2.25 ms a layer), so
# quote the band.
MEASURED_7B_WIDTH_SESSIONS: tuple[MeasuredLayerCosts, ...] = (
    MeasuredLayerCosts(
        per_layer_decode_b1_ms=0.3068160216013591,
        per_layer_decode_b8_ms=0.40278001626332605,
        per_layer_prefill256_ms=1.451375961303711,
        lm_head_ms=_LM_HEAD_BW_MS,
        overhead_ms=0.14629238411258505,
        provenance="tools/layer_costs.py alone, NVIDIA H100 80GB HBM3, 700.00 W; PR 22 run A",
    ),
    MeasuredLayerCosts(
        per_layer_decode_b1_ms=0.310476024945577,
        per_layer_decode_b8_ms=0.4062039454778036,
        per_layer_prefill256_ms=2.2529919147491455,
        lm_head_ms=_LM_HEAD_BW_MS,
        overhead_ms=0.14491368894250056,
        provenance="chip_smoke memory_plan (the bf16 7B resident), NVIDIA H100 80GB HBM3, "
                   "700.00 W; PR 22 run B",
    ),
    MeasuredLayerCosts(
        per_layer_decode_b1_ms=0.323905348777771,
        per_layer_decode_b8_ms=0.42123866081237804,
        per_layer_prefill256_ms=1.405519723892212,
        lm_head_ms=_LM_HEAD_BW_MS,
        overhead_ms=0.146353737160274,
        provenance="chip_smoke memory_plan of the whole script, NVIDIA H100 80GB HBM3, "
                   "700.00 W; PR 22 run C",
    ),
    MeasuredLayerCosts(
        per_layer_decode_b1_ms=0.30791330337524414,
        per_layer_decode_b8_ms=0.44039201736450195,
        per_layer_prefill256_ms=1.7428319454193115,
        lm_head_ms=_LM_HEAD_BW_MS,
        overhead_ms=0.14242316846520564,
        provenance="tools/layer_costs.py alone, NVIDIA H100 80GB HBM3, 700.00 W; PR 22 run D",
    ),
)

def _envelope_width(rows: tuple[MeasuredLayerCosts, ...]) -> MeasuredLayerCosts:
    return MeasuredLayerCosts(
        per_layer_decode_b1_ms=max(s.per_layer_decode_b1_ms for s in rows),
        per_layer_decode_b8_ms=max(s.per_layer_decode_b8_ms for s in rows),
        per_layer_prefill256_ms=max(s.per_layer_prefill256_ms for s in rows),
        lm_head_ms=_LM_HEAD_BW_MS,
        overhead_ms=max(s.overhead_ms for s in rows),
        provenance=f"envelope of {len(rows)} runs: " + "; ".join(r.provenance for r in rows),
    )


@dataclasses.dataclass(frozen=True)
class LatencyProjection:
    """Measurement-derived per-chunk serving latency under TP."""

    cfg_name: str
    n_model: int
    decode_ms_per_token: float     # per decoded token, all streams advance
    prefill_chunk_ms: float        # one ~256-token chunk (2-frame group + text)
    decode_steps: int
    costs: MeasuredLayerCosts

    @property
    def chunk_ms(self) -> float:
        return self.prefill_chunk_ms + self.decode_steps * self.decode_ms_per_token

    def describe(self) -> str:
        return (
            f"{self.cfg_name} TP={self.n_model}: decode "
            f"{self.decode_ms_per_token:.2f} ms/tok, chunk prefill "
            f"{self.prefill_chunk_ms:.1f} ms, per-chunk "
            f"({self.decode_steps} tokens) {self.chunk_ms:.1f} ms "
            f"[{self.costs.provenance}]"
        )


def nvlink_allreduce_ms(nbytes: float, n_model: int) -> float:
    """A ring all-reduce of ``nbytes`` over ``n_model`` cards at the data
    sheet's NVLink rate: an unmeasured lower bound (no per-call latency)."""
    return 2 * (n_model - 1) / n_model * nbytes / (NVLINK_GBPS * 1e9) * 1e3


def serving_latency(
    cfg: ModelConfig,
    costs: Optional[MeasuredLayerCosts] = None,
    *,
    n_model: int,
    batch: int = 1,
    decode_steps: int = 16,
    link_allreduce_ms: Optional[float] = None,
) -> LatencyProjection:
    """Project full-depth serving latency from measured per-layer costs
    (``MEASURED_7B_WIDTH`` by default).

    The layers and the vocab head shard 1 / TP; ``overhead_ms`` does not.
    TP adds two all-reduces a layer of [B, 1, hidden] bf16 at decode;
    ``link_allreduce_ms`` is one of them, by default the NVLink estimate
    (``nvlink_allreduce_ms``), unmeasured, carried so the projection stays
    falsifiable."""
    costs = MEASURED_7B_WIDTH if costs is None else costs
    layers = cfg.text.num_hidden_layers
    if link_allreduce_ms is None:
        link_allreduce_ms = nvlink_allreduce_ms(batch * cfg.text.hidden_size * 2, n_model)
    per_layer = (costs.per_layer_decode_b8_ms if batch >= 8
                 else costs.per_layer_decode_b1_ms)
    comm = (2 * layers * link_allreduce_ms) if n_model > 1 else 0.0
    decode = ((costs.lm_head_ms + layers * per_layer) / n_model
              + costs.overhead_ms + comm)
    prefill = layers * costs.per_layer_prefill256_ms / n_model + comm
    return LatencyProjection(
        cfg_name=cfg.name, n_model=n_model,
        decode_ms_per_token=decode, prefill_chunk_ms=prefill,
        decode_steps=decode_steps, costs=costs,
    )


def serving_latency_band(
    cfg: ModelConfig,
    *,
    n_model: int,
    batch: int = 1,
    decode_steps: int = 16,
) -> tuple[LatencyProjection, LatencyProjection]:
    """(fastest, slowest) projection across every measured run."""
    projs = [
        serving_latency(cfg, s, n_model=n_model, batch=batch,
                        decode_steps=decode_steps)
        for s in MEASURED_7B_WIDTH_SESSIONS
    ]
    projs.sort(key=lambda p: p.chunk_ms)
    return projs[0], projs[-1]


# ---------------------------------------------------------------------------
# Training latency projection from measured per-layer costs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeasuredTrainCosts:
    """Per-layer train-step cost measured on the card at the 7B's width
    (``tools/layer_costs.py``): whole steps (forward, backward with remat,
    AdamW) of ``train/step.py:make_train_step`` at two text depths, one
    row of ``seq`` tokens, differenced so every depth-independent term
    (embedding, the 152k-vocab chunked CE, the head's and embedding's
    AdamW) cancels. ``remainder_ms`` is the depth-independent residual
    (d_lo wall - d_lo * per_layer); its CE bulk would shard under the vocab
    split, the rest would not, and the split was not measured, so
    projections carry it unsharded."""

    per_layer_step_ms: float       # fwd+bwd+AdamW, one decoder layer
    remainder_ms: float            # depth-independent (CE + embed + glue)
    seq: int                       # tokens per step the costs were timed at
    measured_tflops: float         # implied by the matmul-only FLOP model
    vs_calibrated: float           # against the same-process matmul ceiling
    provenance: str


def _envelope_train(rows: tuple[MeasuredTrainCosts, ...]) -> MeasuredTrainCosts:
    return MeasuredTrainCosts(
        per_layer_step_ms=max(s.per_layer_step_ms for s in rows),
        remainder_ms=max(s.remainder_ms for s in rows),
        seq=rows[0].seq,
        measured_tflops=min(s.measured_tflops for s in rows),
        vs_calibrated=min(s.vs_calibrated for s in rows),
        provenance=f"envelope of {len(rows)} runs: " + "; ".join(r.provenance for r in rows),
    )


# tools/layer_costs.py on the card, depths (1, 3), one row of 8192 tokens,
# 4096 supervised, remat, the fused bf16-logit CE; the same two runs.
MEASURED_7B_TRAIN_SESSIONS: tuple[MeasuredTrainCosts, ...] = (
    MeasuredTrainCosts(
        per_layer_step_ms=62.95548999999312,
        remainder_ms=167.62702400001217,
        seq=8192,
        measured_tflops=227.79420510181984,
        vs_calibrated=0.2817491714308223,
        provenance="tools/layer_costs.py alone, NVIDIA H100 80GB HBM3, 700.00 W; PR 22 run A "
                   "(cal 808.5 TFLOP/s)",
    ),
    MeasuredTrainCosts(
        per_layer_step_ms=61.82666849998952,
        remainder_ms=170.10031850001894,
        seq=8192,
        measured_tflops=231.9532355418185,
        vs_calibrated=0.2884631706775507,
        provenance="chip_smoke memory_plan, NVIDIA H100 80GB HBM3, 700.00 W; PR 22 run B "
                   "(cal 804.1 TFLOP/s)",
    ),
    MeasuredTrainCosts(
        per_layer_step_ms=64.75116699999717,
        remainder_ms=169.6190700000102,
        seq=8192,
        measured_tflops=221.47702451979944,
        vs_calibrated=0.2805637503417779,
        provenance="chip_smoke memory_plan of the whole script, NVIDIA H100 80GB HBM3, 700.00 W; "
                   "PR 22 run C (cal 789.4 TFLOP/s)",
    ),
    MeasuredTrainCosts(
        per_layer_step_ms=62.683291499997296,
        remainder_ms=167.42159450000926,
        seq=8192,
        measured_tflops=228.78338801568228,
        vs_calibrated=0.28119885449321813,
        provenance="tools/layer_costs.py alone, NVIDIA H100 80GB HBM3, 700.00 W; PR 22 run D "
                   "(cal 813.6 TFLOP/s)",
    ),
)


MEASURED_7B_WIDTH = _envelope_width(MEASURED_7B_WIDTH_SESSIONS)
MEASURED_7B_TRAIN = _envelope_train(MEASURED_7B_TRAIN_SESSIONS)


@dataclasses.dataclass(frozen=True)
class TrainLatencyProjection:
    """Measurement-derived full-depth train-step latency under DP x TP."""

    cfg_name: str
    n_data: int
    n_model: int
    step_s: float                  # one optimizer step, all DP replicas
    tokens_per_step: int           # global batch tokens (n_data x seq)
    comm_s: float                  # the labelled link estimate inside step_s
    costs: MeasuredTrainCosts

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_per_step / self.step_s

    def describe(self) -> str:
        return (
            f"{self.cfg_name} train DP={self.n_data} TP={self.n_model}: "
            f"step {self.step_s:.2f} s, {self.tokens_per_s:,.0f} tok/s "
            f"(comm est {self.comm_s * 1e3:.0f} ms) [{self.costs.provenance}]"
        )


def training_latency(
    cfg: ModelConfig,
    costs: Optional[MeasuredTrainCosts] = None,
    *,
    n_data: int = 1,
    n_model: int = 1,
    trainable_bytes: float = 6.5e9 * 2,   # bf16 grads of the unfrozen 7B LLM
    link_algo_gbps: float = NVLINK_GBPS,
) -> TrainLatencyProjection:
    """Project the full-depth train step from the measured per-layer cost
    (``MEASURED_7B_TRAIN`` by default).

    Per-layer compute shards 1 / TP; the remainder is carried whole. The
    link terms are estimates at ``link_algo_gbps`` (the data sheet's
    NVLink rate by default, unmeasured): TP adds 4 all-reduces a layer of
    [seq, hidden] bf16 (2 forward, 2 backward), ZeRO-2 one reduce-scatter
    of the trainable bf16 gradients a step (JAX's term; the port's
    ``Zero2`` reduces fp32 gradients once a micro-step, twice the bytes
    each time). Valid at the measured seq only (attention is quadratic in
    it)."""
    costs = MEASURED_7B_TRAIN if costs is None else costs
    layers = cfg.text.num_hidden_layers
    compute_s = (costs.remainder_ms + layers * costs.per_layer_step_ms / n_model) / 1e3
    comm_s = 0.0
    if n_model > 1:
        ar_bytes = costs.seq * cfg.text.hidden_size * 2
        ar_s = 2 * (n_model - 1) / n_model * ar_bytes / (link_algo_gbps * 1e9)
        comm_s += 4 * layers * ar_s
    if n_data > 1:
        rs_s = (n_data - 1) / n_data * (trainable_bytes / n_model) / (link_algo_gbps * 1e9)
        comm_s += rs_s
    return TrainLatencyProjection(
        cfg_name=cfg.name, n_data=n_data, n_model=n_model,
        step_s=compute_s + comm_s,
        tokens_per_step=n_data * costs.seq,
        comm_s=comm_s, costs=costs,
    )


# ---------------------------------------------------------------------------
# Streaming session horizon
# ---------------------------------------------------------------------------

def chunk_tokens(grid_thw: tuple[int, int, int], text_overhead: int = 18) -> int:
    """Tokens appended per streaming chunk: merged visual tokens of one
    2-frame group (t*h*w/4) + the ``Time=a-b s`` user-turn text/markup."""
    t, h, w = grid_thw
    return t * h * w // 4 + text_overhead


@dataclasses.dataclass(frozen=True)
class StreamingHorizon:
    """Session length arithmetic for one stream on a fixed cache."""

    cache_len: int
    start_len: int                 # tokens after the init chunk
    tokens_per_second: float
    compact_keep: int              # 0 = no eviction

    @property
    def seconds_to_exhaustion(self) -> float:
        """Wall-clock until the cache fills WITHOUT eviction."""
        return (self.cache_len - self.start_len) / self.tokens_per_second

    @property
    def unbounded(self) -> bool:
        """With compaction the working set is bounded: the session runs
        forever iff sink+window+chunk headroom fits the cache."""
        if not self.compact_keep:
            return False
        return self.start_len + self.compact_keep < self.cache_len

    @property
    def seconds_between_compactions(self) -> float:
        if not self.compact_keep:
            return float("inf")
        return (self.cache_len - self.start_len - self.compact_keep) / self.tokens_per_second


def streaming_horizon(
    grid_thw: tuple[int, int, int],
    *,
    cache_len: int,
    start_len: int = 1024,
    chunks_per_second: float = 1.0,
    compact_keep: int = 0,
    decode_tokens_per_chunk: int = 16,
) -> StreamingHorizon:
    """Horizon for the live cadence: one 2-frame chunk per second plus the
    kept decode tokens (all but the final sampled token)."""
    tps = (chunk_tokens(grid_thw) + decode_tokens_per_chunk - 1) * chunks_per_second
    return StreamingHorizon(
        cache_len=cache_len, start_len=start_len,
        tokens_per_second=tps, compact_keep=compact_keep,
    )

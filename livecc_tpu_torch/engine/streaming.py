"""LiveCC streaming engine: interleaved frame-chunk prefill + word decode.

Port of ``livecc_tpu/engine/streaming.py:LiveCCEngine``; the multi-stream
pool built on it is ``serve/scheduler.py``. The per-chunk loop of the
reference's ``LiveCCDemoInfer``: build
the ``Time=a-b s`` turn, tokenize, prefill the chunk into one growing KV
cache, decode up to ``max_new_tokens`` words. Kept exactly as in JAX, so the
two engines emit the same tokens on the same weights:

  * prompt chunks are right-padded to the ``TOKEN_BUCKETS`` sizes;
  * the cache doubles when a chunk would not fit, and at ``cache_len`` it
    compacts (sink + recent window) instead, with the same arithmetic, so
    growth and compaction happen at the same chunk;
  * 6-frame (3 s) first chunk, then 2-frame (1 s) chunks; the system prompt
    is stripped from continuation turns; history continues from all but
    each chunk's final sampled token.

``spec`` (``engine/speculative.py:SpecConfig``) turns on speculative
decoding, whose greedy output is the same: fused lookahead
(``decode_chunk_lookahead``, drafting from ``StreamState.hist``) with the
adaptive controller choosing it or plain ``decode_chunk`` per chunk, or the
host-drafted window loop (``fused=False``, draft source
``spec_draft_source``, n-gram lookup by default).

Tensor-parallel serving is the same class on a model split by
``parallel/sharding.py:shard_params`` over the mesh's model axis, one
process a rank (as JAX's ``README.md`` runs the same engine on sharded
params): each rank's cache holds its Hk / M heads (``KVCache.zeros(tp=)``,
growth copies them as they are), every rank gets the whole logits
(``lm_logits``' all-gather), so every rank selects, samples (its generator
seeded alike) and schedules the same tokens. Quantize before sharding:
``quantize_model`` refuses a split model.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.data import chat
from livecc_tpu_torch.data.tokenizer import Tokenizer
from livecc_tpu_torch.engine.compact import compact_cache_row, compact_token_row, plan_compaction
from livecc_tpu_torch.engine.generation import GenerationParams, decode_chunk, prefill
from livecc_tpu_torch.engine.speculative import (
    SpecConfig, SpecController, decode_chunk_lookahead, speculative_decode_chunk)
from livecc_tpu_torch.models.qwen2_vl.model import Qwen2VL, VisionInputs, get_rope_index
from livecc_tpu_torch.models.qwen2_vl.text import KVCache
from livecc_tpu_torch.ops.quant import quantize_model
from livecc_tpu_torch.ops.rope import vision_rotary_cos_sin
from livecc_tpu_torch.utils.metrics import LatencyTracker
from livecc_tpu_torch.vision_io.budget import VisionBudget
from livecc_tpu_torch.vision_io.patchify import device_patchify, grid_for_frames

TOKEN_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


def _bucket(n: int, buckets: Sequence[int] = TOKEN_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"chunk of {n} tokens exceeds the largest bucket {buckets[-1]}")


@dataclasses.dataclass
class StreamState:
    """Per-stream state: device tensors + host-side shadows.

    ``length`` mirrors cache.offset on the host so bookkeeping never reads
    the device; ``counts`` is the device-resident repetition-penalty
    presence; ``logits`` holds the last chunk's prefill logits [1, V]."""

    cache: KVCache
    counts: torch.Tensor                     # [1, V] int32 token counts
    past_ids: list[int]
    length: int = 0                          # host shadow of cache.offset
    last_token: int = -1                     # prev chunk's dropped final token
    rope_delta: int | None = None            # set by the first prefill
    logits: torch.Tensor | None = None
    # id-shadow of the KV cache ([1, Hcap] int32) that fused lookahead
    # decoding drafts from (engine/speculative.py); allocated when spec.fused
    hist: torch.Tensor | None = None


@dataclasses.dataclass
class ChunkRecord:
    """One chunk as the engine ran it. ``seconds`` is host wall time that
    ends after the generated tokens reached the host (so it covers the
    device work)."""

    seconds: float
    prompt_tokens: int
    generated_tokens: int
    dropped_tokens: int                      # evicted by compaction before this chunk
    windows: int = 0                         # verify windows (0 where plain decode ran)


class LiveCCEngine:
    """Single-stream streaming commentary engine."""

    fps = 2.0
    initial_fps_frames = 6
    streaming_fps_frames = 2

    def __init__(
        self,
        model: Qwen2VL,
        cfg: ModelConfig,
        tokenizer: Tokenizer,
        *,
        budget: VisionBudget | None = None,
        cache_len: int = 8192,
        cache_dtype: torch.dtype | None = None,
        compact_keep: int | None = None,
        compact_sink_cap: int = 1024,
        quantize_weights: bool | None = None,
        spec: SpecConfig | None = None,
    ):
        """``quantize_weights=True`` quantizes ``model``'s matmul weights to
        int8 IN PLACE (``ops/quant.py:quantize_model``; every later user of
        the model sees them), so every quantized matmul runs through K5; a
        model quantized before is served as it is. None resolves to False on
        every device: JAX's TPU default (int8 weights, its soak A/B) is not
        taken over, since the choice on the card waits for the port's
        benchmark to A/B the two."""
        if quantize_weights:
            quantize_model(model)
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = next(model.parameters()).device
        # the visual-token budget that sizes a video's frames (engine/live.py)
        self.budget = budget or VisionBudget()
        self.cache_len = cache_len
        # bf16 KV on the GPU (half the fp32 bytes); fp32 elsewhere (the CPU
        # parity path). torch.int8 stores a quantized cache (half of bf16's
        # bytes again) and runs the int8 attention kernels.
        if cache_dtype is None:
            cache_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.cache_dtype = cache_dtype
        # Solo-stream session horizon: once the cache has doubled up to
        # cache_len, evict (sink + recent window) instead of growing. None =
        # half the ceiling; 0 disables (the cache then doubles without bound).
        self.compact_keep = cache_len // 2 if compact_keep is None else compact_keep
        self.compact_sink_cap = compact_sink_cap
        # speculative decoding; ``spec_draft_source`` overrides the host loop's
        # n-gram lookup (tests inject oracle and adversarial drafts)
        self.spec = spec
        self.spec_draft_source = None
        self._spec_ctl: SpecController | None = None
        self.sys_offset = chat.system_prompt_offset()
        # sampling draws (do_sample=True) come from one seeded generator
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self._vision_aux_cache: dict = {}
        self.chunk_log: list[ChunkRecord] = []
        self._dropped = 0
        self.metrics = LatencyTracker()

    def _spec_on(self) -> bool:
        """The adaptive lookahead gate for this chunk (True: run lookahead)."""
        if self._spec_ctl is None:
            self._spec_ctl = SpecController(self.spec, self.model.text.tp)
        return self._spec_ctl.use_spec()

    # ------------------------------------------------------------------
    # state management
    # ------------------------------------------------------------------

    def new_stream(self, cache_len: int | None = None) -> StreamState:
        """``cache_len`` overrides the engine's for this stream's initial
        cache (it doubles on demand); the serving pool starts joining streams
        small so that N of them never hold N full-length caches beside it."""
        n = cache_len or self.cache_len
        cache = KVCache.zeros(self.cfg.text, 1, n, self.cache_dtype, self.device,
                              self.model.text.tp)
        counts = torch.zeros((1, self.cfg.text.vocab_size), dtype=torch.int32, device=self.device)
        hist = None
        if self.spec is not None and self.spec.fused:
            hist = torch.full((1, n), -1, dtype=torch.int32, device=self.device)
        return StreamState(cache=cache, counts=counts, past_ids=[], hist=hist)

    def _ensure_capacity(self, state: StreamState, needed: int) -> None:
        off = state.length
        cap = state.cache.max_len
        if off + needed <= cap:
            return
        # at the ceiling, compact instead of growing
        if cap >= self.cache_len and self.compact_keep:
            old_off = int(state.cache.offset[0])
            sink, keep, new_off = plan_compaction(
                old_off, self.compact_sink_cap, self.compact_keep, cap)
            if new_off < old_off and new_off + needed <= cap:
                state.cache = compact_cache_row(state.cache, 0, sink, keep)
                if state.hist is not None:
                    compact_token_row(state.hist, old_off, 0, sink, keep)
                state.rope_delta += old_off - new_off
                state.length = new_off
                self._dropped += old_off - new_off
                self.metrics.record("cache_compaction_dropped_tokens", float(old_off - new_off))
                return
        new_cap = cap
        while off + needed > new_cap:
            new_cap *= 2

        def grow(buf: torch.Tensor | None, dim: int) -> torch.Tensor | None:
            # dim 3: positions of K/V [L, B, Hk, Smax, D]; dim 4: lane-major
            # scales [L, B, Hk, 1, Smax]
            if buf is None:
                return None
            shape = list(buf.shape)
            shape[dim] = new_cap
            out = buf.new_zeros(shape)
            out.narrow(dim, 0, cap).copy_(buf)
            return out

        c = state.cache
        state.cache = KVCache(grow(c.k, 3), grow(c.v, 3), c.offset,
                              grow(c.k_scale, 4), grow(c.v_scale, 4))
        if state.hist is not None:
            state.hist = torch.cat([state.hist, state.hist.new_full(
                (1, new_cap - state.hist.shape[1]), -1)], dim=1)

    # ------------------------------------------------------------------
    # one chunk: text+frames -> generated words
    # ------------------------------------------------------------------

    @torch.no_grad()
    def chunk_step(
        self,
        state: StreamState,
        frames: np.ndarray | None,          # [T, H, W, 3] uint8 pre-scaled frames or None
        t0: float,
        t1: float,
        query: str | None,
        gen: GenerationParams,
    ) -> str:
        """Run one interleave step; returns decoded new text."""
        content: list[dict] = [{"type": "text", "text": f"Time={t0:.1f}-{t1:.1f}s"}]
        if frames is not None:
            content.append({"type": "video", "video": None})
        if query is not None:
            content.append({"type": "text", "text": query})
        with self.metrics.measure("chunk_step"):
            return self._user_turn(state, content, frames, gen)

    @torch.no_grad()
    def qa_turn(
        self,
        state: StreamState,
        frames: np.ndarray | None,
        message: str,
        gen: GenerationParams,
    ) -> str:
        """One QA turn over the shared cache (video attached if given)."""
        content: list[dict] = []
        if frames is not None:
            content.append({"type": "video", "video": None})
        content.append({"type": "text", "text": message})
        return self._user_turn(state, content, frames, gen)

    def _user_turn(self, state, content, frames, gen) -> str:
        t_start = time.perf_counter()
        dropped0 = self._dropped
        grid = None
        vision = None
        if frames is not None:
            grid, vision = self._device_vision(frames)
        text = chat.render_chat([{"role": "user", "content": content}], add_generation_prompt=True)
        if state.rope_delta is not None:
            text = chat.strip_system_for_continuation(text, self.sys_offset)
        if grid is not None:
            text = chat.expand_vision_placeholders(text, video_grid_thw=[grid])
        new_ids = self.tokenizer.encode(text)
        generated, windows = self._run_chunk(state, new_ids, vision, grid, gen)
        self.chunk_log.append(ChunkRecord(time.perf_counter() - t_start, len(new_ids),
                                          len(generated), self._dropped - dropped0, windows))
        return self.tokenizer.decode(generated, skip_special_tokens=True)

    def _device_vision(self, frames: np.ndarray):
        """uint8 [T, H, W, 3] frames -> (grid_thw, VisionInputs) on the device.

        Frames go to the device as uint8; rotary tables and segment ids are
        cached per grid (for a streaming video they are built once)."""
        t, h, w, _ = frames.shape
        grid = grid_for_frames(t, h, w, self.cfg.vision)
        patches = device_patchify(torch.from_numpy(np.ascontiguousarray(frames)).to(self.device))
        return grid, self.vision_aux(grid, patches)

    def vision_aux(self, grid, patches: torch.Tensor | None = None) -> VisionInputs:
        """ViT inputs for ``grid`` around ``patches``: the rotary tables and
        segment ids are built once per grid and kept on the device (the
        serving pool shares them across every stream of a resolution class)."""
        aux = self._vision_aux_cache.get(grid)
        if aux is None:
            cos, sin = vision_rotary_cos_sin(
                [grid], self.cfg.vision.head_dim,
                spatial_merge_size=self.cfg.vision.spatial_merge_size,
            )
            seg = np.repeat(np.arange(grid[0]), grid[1] * grid[2]).astype(np.int32)
            aux = tuple(torch.from_numpy(a).to(self.device) for a in (cos, sin, seg))
            self._vision_aux_cache[grid] = aux
        cos, sin, seg = aux
        return VisionInputs(patches=patches, cos=cos, sin=sin, seg_ids=seg,
                            group=grid[1] * grid[2])

    def _run_chunk(
        self,
        state: StreamState,
        new_ids: list[int],
        vision: Optional[VisionInputs],
        grid,
        gen: GenerationParams,
    ) -> tuple[list[int], int]:
        """Prefill and decode one chunk: (the generated ids, verify windows)."""
        n_new = len(new_ids)
        bucket = _bucket(n_new)
        # a verify window writes up to k_draft + 1 KVs past the accepted
        # frontier; reserve one full window beyond the final emitted token
        extra = (self.spec.k_draft + 2) if self.spec is not None else 0
        self._ensure_capacity(state, bucket + gen.max_new_tokens + 1 + extra)
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :n_new] = new_ids
        offset = state.length

        if state.rope_delta is None:
            # first chunk: true 3D M-RoPE positions over the full prompt
            pos, delta = get_rope_index(
                self.cfg,
                np.asarray(new_ids)[None],
                video_grid_thw=np.asarray([grid]) if grid is not None else None,
            )
            state.rope_delta = int(delta[0, 0])
            pos_pad = np.zeros((3, 1, bucket), np.int32)
            pos_pad[:, :, :n_new] = pos
            pos_pad[:, :, n_new:] = pos[:, :, -1:] + np.arange(1, bucket - n_new + 1)
        else:
            # continuation: flat offset + delta positions
            pos_pad = np.broadcast_to(
                (np.arange(bucket) + offset + state.rope_delta)[None, None], (3, 1, bucket)
            ).astype(np.int32)

        dev = self.device
        ids_dev = torch.from_numpy(ids).to(dev)
        logits0, state.cache, state.counts = prefill(
            self.model, self.cfg, ids_dev,
            torch.from_numpy(np.ascontiguousarray(pos_pad)).to(dev),
            n_new, state.cache, vision=vision,
            counts=state.counts, remove_token=state.last_token,
        )
        state.logits = logits0
        rope_delta = torch.tensor([[state.rope_delta]], dtype=torch.int32, device=dev)
        windows = 0
        if self.spec is not None and not self.spec.fused:
            generated, windows = speculative_decode_chunk(
                self, state, logits0, gen, self.spec, context_ids=state.past_ids + new_ids,
                draft_source=self.spec_draft_source)
        elif self.spec is not None and self._spec_on():
            t0 = time.perf_counter()
            tokens, n_gen, state.cache, state.hist, state.counts, n_iters = (
                decode_chunk_lookahead(self.model, self.cfg, gen, self.spec, ids_dev, n_new,
                                       logits0, state.cache, state.hist, state.counts,
                                       rope_delta, generator=self.generator))
            n = int(n_gen[0])
            generated = tokens[0, :n].cpu().tolist()
            windows = int(n_iters)
            # the tokens on the host end the chunk's device work: an honest
            # wall for the controller (the prefill included, as both modes pay it)
            self._spec_ctl.observe_wall(True, time.perf_counter() - t0, n)
            self._spec_ctl.observe(n, 1, windows)
        else:
            # plain decode; with spec on, the controller chose it this chunk
            # (``hist`` goes stale: only later drafts suffer, never the output)
            t0 = time.perf_counter()
            tokens, n_gen, state.cache, state.counts = decode_chunk(
                self.model, self.cfg, gen, logits0, state.cache, state.counts, rope_delta,
                generator=self.generator,
            )
            n = int(n_gen[0])
            generated = tokens[0, :n].cpu().tolist()
            if self._spec_ctl is not None:
                self._spec_ctl.observe_wall(False, time.perf_counter() - t0, n)
        # history keeps all but the final sampled token; its presence count
        # is removed at the next chunk's prefill
        state.past_ids = state.past_ids + new_ids + generated[:-1]
        state.length = offset + n_new + max(len(generated) - 1, 0)
        state.last_token = generated[-1] if generated else -1
        return generated, windows

    # ------------------------------------------------------------------
    # offline evaluation API (reference demo/infer.py:244-310)
    # ------------------------------------------------------------------

    def live_cc_once_for_evaluation(
        self,
        query: str,
        frames: np.ndarray,                  # [T, H, W, 3] uint8 pre-scaled, strict-fps sampled
        *,
        video_start: float = 0.0,
        max_new_tokens: int = 32,
        repetition_penalty: float = 1.05,
        do_sample: bool = False,
        state: StreamState | None = None,
    ) -> list[list]:
        """Whole-clip chunked commentary; returns [[t0, t1, text], ...].
        ``state`` (a fresh ``new_stream()`` by default) is left holding the
        session, e.g. its last logits."""
        gen = GenerationParams(
            max_new_tokens=max_new_tokens,
            eos_token_id=self.cfg.eos_token_id,
            pad_token_id=self.cfg.pad_token_id,
            do_sample=do_sample,
            repetition_penalty=repetition_penalty,
        )
        state = self.new_stream() if state is None else state
        chunks: list[np.ndarray] = [frames[: self.initial_fps_frames]]
        rest = frames[self.initial_fps_frames:]
        chunks += [rest[i:i + self.streaming_fps_frames]
                   for i in range(0, len(rest), self.streaming_fps_frames)]
        out = []
        t1 = 0.0
        for i, clip in enumerate(chunks):
            if len(clip) == 0:
                continue
            t0, t1 = ((0.0, self.initial_fps_frames / self.fps) if i == 0
                      else (t1, t1 + self.streaming_fps_frames / self.fps))
            text = self.chunk_step(state, clip, t0, t1, query if i == 0 else None, gen)
            out.append([video_start + t0, video_start + t1, text])
        return out

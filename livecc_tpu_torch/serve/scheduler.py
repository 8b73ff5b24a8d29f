"""Multi-stream serving: a fixed-capacity slot pool on one model replica.

Port of ``livecc_tpu/serve/scheduler.py``. The target deployment is >= 8
concurrent 1 fps streams per replica:

  * steady-state streams live in a **slot pool**: KV caches (int8 with
    lane-major scales, or bf16/fp32), presence counts and last-token markers
    stay on the device as ``[C, ...]`` tensors; a tick runs ONE batched
    prefill + ONE batched decode over the whole pool, every row at its own
    cache depth (per-row offsets go to the kernels as device tensors);
  * continuation positions come from each slot's device offset, and the
    previous chunk's dropped final token flows decode -> next prefill as a
    device tensor;
  * idle slots ride along inert (valid_len 0, active False: offsets, counts
    and caches unchanged);
  * steady frames are patchified on the device at submit time; a tick stacks
    every ready stream's patches into one ``[C, Np, pd]`` batch, and the
    vision tower runs once over all rows' groups with shared rotary tables
    (one batch per resolution class);
  * streams joining mid-flight run their 6-frame init chunk solo through the
    single-stream engine (3D M-RoPE positions) in a small cache, then adopt
    a pool slot by a prefix copy;
  * with the engine's fused ``spec`` the tick decodes by lookahead
    (``decode_chunk_lookahead``) over the pool's ``hist`` shadow, or by
    plain decode where the adaptive controller (``SpecController``, fed
    each tick's wall) measures that faster.

Collection is synchronous (the JAX server collects on a background
thread): the host drives the decode loop (on the card, one replay of the
captured decode step and one stop-flag read per step, ``engine/graphs.py``),
so when a tick's pool step returns its tokens are done; the
tick copies them to the host at once and stamps each chunk's text with the
moment it reached the host (``drain_timed``). Nothing is in flight between
ticks, so ``flush`` and ``drain(sync=...)`` have nothing to wait for.

On a model split over the mesh's model axis every model rank runs the
same server (one process a rank): the pool's caches hold the rank's
Hk / M heads, and every host decision (adoption, growth, compaction,
ticks, the controller's mode) reads state that every rank holds alike
(tokens and offsets from the gathered logits, walls agreed by
``SpecController``), so the ranks issue the same collectives in the same
order. ``snapshot`` gathers the heads into one card's layout, ``restore``
takes each rank's back.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.data import chat
from livecc_tpu_torch.engine.compact import compact_cache_row, compact_token_row, plan_compaction
from livecc_tpu_torch.engine.generation import GenerationParams, decode_chunk, prefill
from livecc_tpu_torch.engine.speculative import SpecConfig, SpecController, decode_chunk_lookahead
from livecc_tpu_torch.engine.streaming import LiveCCEngine, StreamState, _bucket
from livecc_tpu_torch.models.qwen2_vl.model import Qwen2VL, VisionInputs
from livecc_tpu_torch.models.qwen2_vl.text import KVCache
from livecc_tpu_torch.ops import build
from livecc_tpu_torch.parallel.tp import gather_from_model
from livecc_tpu_torch.vision_io.patchify import device_patchify, grid_for_frames

# Initial solo-cache length for joining streams (an init chunk is ~1k tokens;
# the solo cache doubles on demand).
INIT_CACHE_LEN = 2048


def _init_cache_len(engine: LiveCCEngine) -> int:
    return min(INIT_CACHE_LEN, engine.cache_len)


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a cache dtype ("int8", "float32", "bfloat16"), as the
    JAX snapshot format writes it."""
    return str(dtype).removeprefix("torch.")


def make_pool_step(cfg: ModelConfig, gen: GenerationParams, spec: SpecConfig | None = None):
    """One tick over the pool: batched prefill + batched decode.

    Every row sits at its own cache depth: positions, key validity and the
    cache writes use the per-row offsets, so the GEMMs stay batched and the
    attention kernels see the whole pool in one launch per layer. The
    prefill runs eagerly; on the card the decode replays the graph captured
    over the pool's cache (``decode_chunk``), or with ``spec`` (a fused
    ``SpecConfig``) the lookahead graph over the cache and ``hist``
    (``decode_chunk_lookahead``). Returns ``(tokens, n_gen, cache, counts,
    last_tokens, hist, n_iters)``; ``n_iters`` (verify windows) is None for
    plain decode."""

    @torch.no_grad()
    def run(model: Qwen2VL, ids, valid, cache: KVCache, patches, cos, sin, seg, counts,
            last_tokens, deltas, active, generator=None, group=None, hist=None):
        b, sb = ids.shape
        dev = ids.device
        pos = (torch.arange(sb, device=dev)[None, None, :]
               + (cache.offset + deltas)[None, :, None]).expand(3, b, sb).to(torch.int32)
        remove = torch.where(active, last_tokens, torch.full_like(last_tokens, -1))
        vision = VisionInputs(patches=patches, cos=cos, sin=sin, seg_ids=seg, group=group)
        logits0, cache, counts = prefill(model, cfg, ids, pos, valid, cache, vision=vision,
                                         counts=counts, remove_token=remove)
        n_iters = None
        if spec is not None:
            tokens, n_gen, cache, hist, counts, n_iters = decode_chunk_lookahead(
                model, cfg, gen, spec, ids, valid, logits0, cache, hist, counts, deltas[:, None],
                generator, active=active)
        else:
            tokens, n_gen, cache, counts = decode_chunk(model, cfg, gen, logits0, cache, counts,
                                                        deltas[:, None], generator, active=active)
        rows = torch.arange(b, device=dev)
        new_last = torch.where(n_gen > 0, tokens[rows, (n_gen - 1).clamp(min=0).long()],
                               torch.full_like(n_gen, -1)).to(torch.int32)
        last_tokens = torch.where(active, new_last, last_tokens)
        return tokens, n_gen, cache, counts, last_tokens, hist, n_iters

    return run


@torch.no_grad()
def _insert_slot(pool_cache: KVCache, pool_counts: torch.Tensor, pool_last: torch.Tensor,
                 slot: int, cache: KVCache, counts: torch.Tensor, last: int,
                 pool_hist: torch.Tensor | None = None, hist: torch.Tensor | None = None) -> None:
    """Copy a (possibly SHORTER) solo cache into pool slot ``slot``, in place.

    Init streams start with a small cache, so N joining streams never hold N
    full-length caches next to the pool; positions past the solo length keep
    whatever the slot held and sit beyond the row's kv_limit, so they are
    never attended. ``hist`` (the lookahead id-shadow) rides along when
    speculation is on."""
    s = cache.max_len
    pool_cache.k[:, slot, :, :s] = cache.k[:, 0]
    pool_cache.v[:, slot, :, :s] = cache.v[:, 0]
    if pool_cache.quantized:
        pool_cache.k_scale[:, slot, :, :, :s] = cache.k_scale[:, 0]   # lane-major
        pool_cache.v_scale[:, slot, :, :, :s] = cache.v_scale[:, 0]
    offset = pool_cache.offset.clone()
    offset[slot] = cache.offset[0]
    pool_cache.offset = offset
    pool_counts[slot] = counts[0]
    pool_last[slot] = last
    if pool_hist is not None:
        pool_hist[slot, :hist.shape[-1]] = hist[0]


@dataclasses.dataclass
class Stream:
    sid: int
    resolution: tuple[int, int]
    query: str | None = None
    query_sent: bool = False
    slot: int | None = None              # pool slot once past the init chunk
    init_state: Optional[StreamState] = None
    rope_delta: int | None = None
    length_ub: int = 0                   # host upper bound on cache length
    sink_len: int = 0                    # tokens to pin under compaction
    pending: Optional[tuple] = None
    outputs: list = dataclasses.field(default_factory=list)


class StreamServer:
    """Continuous batching of LiveCC streams sharing one model replica.

    ``compact_keep`` bounds every stream's attended KV window: when a
    stream's cache nears the pool size, the middle of its history is evicted
    (sink prefix + recent window kept) and the dropped length folds into its
    rope_delta, so sessions run unbounded on a fixed pool. 0 disables it (the
    pool then raises when exhausted); None = half the pool."""

    def __init__(self, engine: LiveCCEngine, gen: GenerationParams, capacity: int = 8,
                 compact_keep: int | None = None, compact_sink_cap: int = 1024):
        self.engine = engine
        self.gen = gen
        self.capacity = capacity
        self.compact_keep = (engine.cache_len // 2 if compact_keep is None
                             else compact_keep)
        self.compact_sink_cap = compact_sink_cap
        self._streams: dict[int, Stream] = {}
        self._next_sid = 0
        self._steps: dict[bool, object] = {}             # use_spec -> pool step
        self._spec_ctl: Optional[SpecController] = None
        # pool device state (lazy)
        self.pool_caches: Optional[KVCache] = None      # [L, C, ...]
        self.pool_counts: Optional[torch.Tensor] = None  # [C, V] int32
        self.pool_last: Optional[torch.Tensor] = None    # [C] int32
        self.pool_hist: Optional[torch.Tensor] = None    # [C, Smax] int32 (lookahead)
        self._free: list[int] = list(range(capacity))

    def _spec(self) -> SpecConfig | None:
        """The engine's fused SpecConfig, or None (lookahead off)."""
        sp = self.engine.spec
        return sp if (sp is not None and sp.fused) else None

    def _ctl(self) -> SpecController:
        if self._spec_ctl is None:
            self._spec_ctl = SpecController(self._spec(), self.engine.model.text.tp)
        return self._spec_ctl

    def _get_step(self, use_spec: bool):
        """The pool step of a decode mode (lookahead or plain)."""
        key = bool(use_spec and self._spec() is not None)
        if key not in self._steps:
            self._steps[key] = make_pool_step(self.engine.cfg, self.gen,
                                              self._spec() if key else None)
        return self._steps[key]

    # -- stream lifecycle -------------------------------------------------

    def add_stream(self, resolution: tuple[int, int], query: str | None = None) -> int:
        if len(self._streams) >= self.capacity:
            raise RuntimeError(f"server at capacity ({self.capacity} streams)")
        sid = self._next_sid
        self._next_sid += 1
        self._streams[sid] = Stream(
            sid=sid, resolution=resolution, query=query,
            init_state=self.engine.new_stream(cache_len=_init_cache_len(self.engine)),
        )
        return sid

    def remove_stream(self, sid: int) -> None:
        s = self._streams.pop(sid, None)
        if s is not None and s.slot is not None:
            self._free.append(s.slot)

    def submit_chunk(self, sid: int, frames: np.ndarray, t0: float, t1: float) -> None:
        """Queue one chunk ([T, H, W, 3] uint8 pre-scaled frames).

        An adopted stream's frames are patchified on the device right away.
        The submit time rides with the chunk: when its text reaches the host
        the server records ``chunk_submit_to_text`` and stamps the output row
        for ``drain_timed``."""
        s = self._streams[sid]
        sub_ts = time.perf_counter()
        if s.slot is not None:
            t, h, w = frames.shape[:3]
            grid = grid_for_frames(t, h, w, self.engine.cfg.vision)
            staged = device_patchify(
                torch.from_numpy(np.ascontiguousarray(frames)).to(self.engine.device))
            s.pending = ((staged, grid), t0, t1, sub_ts)
        else:
            s.pending = (frames, t0, t1, sub_ts)

    def drain(self, sid: int, sync: bool = True) -> list[tuple[tuple[float, float], str]]:
        """Collected outputs of a stream as ``(span, text)`` rows."""
        return [(span, text) for span, text, _ts in self.drain_timed(sid, sync=sync)]

    def drain_timed(self, sid: int, sync: bool = True,
                    ) -> list[tuple[tuple[float, float], str, float]]:
        """Like drain, but each row carries the ``time.perf_counter()`` at
        which its text reached the host. ``sync`` is the JAX API's; every
        tick has already collected its text here."""
        out = self._streams[sid].outputs
        self._streams[sid].outputs = []
        return out

    def flush(self) -> None:
        """The JAX API's wait for in-flight results: every tick here
        collects its own, so there is nothing to wait for."""

    # -- snapshot / restore (serving failure recovery) --------------------

    def snapshot(self, path: str) -> None:
        """Persist every ADOPTED stream's session (KV cache row, scales,
        presence counts, the lookahead ``hist`` row, rope_delta, host metadata)
        to one .npz in the JAX
        package's format: the same keys, floats as fp32 (npz has no bf16),
        and the cache dtype's numpy name in the meta. Streams still in their
        init chunk and pending (submitted, un-ticked) chunks are not saved.

        On a model split over the model axis every model rank calls it: the
        cache rows' heads are gathered over the group, so the file holds
        one card's layout (as JAX's ``np.asarray`` of a sharded cache),
        model rank 0 writes it, and the group waits for the write."""
        tp = self.engine.model.text.tp

        def as_np(t: torch.Tensor, heads: bool = False) -> np.ndarray:
            if heads and tp is not None:          # [L, Hk / M, ...] -> [L, Hk, ...]
                t = gather_from_model(t.movedim(1, -1), tp).movedim(-1, 1)
            t = t.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

        arrays: dict[str, np.ndarray] = {}
        meta = []
        pool = self.pool_caches
        for s in self._streams.values():
            if s.slot is None:
                continue
            slot = s.slot
            arrays[f"k_{s.sid}"] = as_np(pool.k[:, slot], heads=True)
            arrays[f"v_{s.sid}"] = as_np(pool.v[:, slot], heads=True)
            if pool.quantized:
                arrays[f"ks_{s.sid}"] = as_np(pool.k_scale[:, slot], heads=True)
                arrays[f"vs_{s.sid}"] = as_np(pool.v_scale[:, slot], heads=True)
            arrays[f"counts_{s.sid}"] = as_np(self.pool_counts[slot])
            if self.pool_hist is not None:
                arrays[f"hist_{s.sid}"] = as_np(self.pool_hist[slot])
            meta.append({
                "sid": s.sid, "resolution": list(s.resolution),
                "query": s.query, "query_sent": s.query_sent,
                "rope_delta": s.rope_delta, "length_ub": s.length_ub,
                "sink_len": s.sink_len,
                "offset": int(pool.offset[slot]),
                "last": int(self.pool_last[slot]),
            })
        arrays["__meta__"] = np.frombuffer(
            json.dumps({"streams": meta, "cache_len": self.engine.cache_len,
                        "dtype": _dtype_name(self.engine.cache_dtype)}).encode(),
            np.uint8,
        )
        if tp is None or tp.rank == 0:
            np.savez(path, **arrays)
        if tp is not None:
            dist.barrier(group=tp.group)

    def restore(self, path: str) -> list[int]:
        """Re-adopt snapshotted sessions (from this port or the JAX package)
        into this server's pool; returns the restored stream ids
        (renumbered). A cache row longer than this pool raises. On a split
        model each model rank takes its own heads of every row."""
        data = np.load(path)
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        want = _dtype_name(self.engine.cache_dtype)
        if meta.get("dtype") != want:
            raise ValueError(
                f"snapshot KV dtype {meta.get('dtype')} != engine {want}; "
                "restore into an engine with the same cache_dtype")
        self._ensure_pool()
        pool = self.pool_caches
        dev = self.engine.device
        tp = self.engine.model.text.tp
        hk = pool.k.shape[2]                     # this rank's heads
        heads = slice(0, hk) if tp is None else slice(tp.rank * hk, (tp.rank + 1) * hk)
        restored = []
        for m in meta["streams"]:
            if not self._free:
                raise RuntimeError("restore: server out of slots")
            off = m["offset"]
            if off > pool.max_len:
                raise RuntimeError("restored cache longer than this pool")
            old = m["sid"]
            sid = self._next_sid
            self._next_sid += 1
            slot = self._free.pop(0)

            def put(pool_arr: torch.Tensor, arr: np.ndarray, pos_axis: int) -> None:
                # arr is one slot's row of every head: the pool's layout
                # without the slot axis, so positions sit on pos_axis - 1
                a = torch.from_numpy(arr[:, heads]).to(device=dev, dtype=pool_arr.dtype)
                n = min(a.shape[pos_axis - 1], pool_arr.shape[pos_axis])
                pool_arr[:, slot].narrow(pos_axis - 1, 0, n).copy_(a.narrow(pos_axis - 1, 0, n))

            put(pool.k, data[f"k_{old}"], pos_axis=3)
            put(pool.v, data[f"v_{old}"], pos_axis=3)
            if pool.quantized:
                put(pool.k_scale, data[f"ks_{old}"], pos_axis=4)
                put(pool.v_scale, data[f"vs_{old}"], pos_axis=4)
            offset = pool.offset.clone()
            offset[slot] = off
            pool.offset = offset
            self.pool_counts[slot] = torch.from_numpy(data[f"counts_{old}"]).to(dev)
            if self.pool_hist is not None and f"hist_{old}" in data:
                h = torch.from_numpy(data[f"hist_{old}"]).to(dev)
                n = min(h.shape[-1], self.pool_hist.shape[-1])
                self.pool_hist[slot, :n] = h[:n]
            # (a missing hist leaves -1s: drafts miss until new history
            # accumulates; the output stays exact by acceptance)
            self.pool_last[slot] = m["last"]
            self._streams[sid] = Stream(
                sid=sid, resolution=tuple(m["resolution"]), query=m["query"],
                query_sent=m["query_sent"], slot=slot,
                rope_delta=m["rope_delta"], length_ub=m["length_ub"],
                sink_len=m["sink_len"],
            )
            restored.append(sid)
        return restored

    # -- warmup --------------------------------------------------------------

    def warmup(
        self,
        resolutions: list[tuple[int, int]],
        *,
        query: str = "Please describe the video.",
        init_frames: int = 6,
        steady_frames: int = 2,
    ) -> None:
        """Get every path a session at these resolution classes takes ready
        before the first stream arrives: the kernels are built (on the GPU),
        the solo init path and one pool step per resolution run once on a
        scratch pool (the allocator, cuBLAS and the kernels see their serving
        shapes; on the GPU the pool step captures its decode graph there:
        with lookahead on, the lookahead graph and, where the adaptive
        controller can switch, the plain one too), and no stream state
        changes. When no pool exists yet the scratch BECOMES the pool
        (offsets, counts and markers reset), so a pre-serve warmup never holds
        two pools, and the first served tick replays the graph captured
        here."""
        engine = self.engine
        if engine.device.type == "cuda":
            build.load_library()
        adopt_scratch = self.pool_caches is None
        c = self.capacity
        dev = engine.device
        scratch = KVCache.zeros(engine.cfg.text, c, engine.cache_len, engine.cache_dtype, dev,
                                engine.model.text.tp)
        counts = torch.zeros((c, engine.cfg.text.vocab_size), dtype=torch.int32, device=dev)
        last = torch.full((c,), -1, dtype=torch.int32, device=dev)
        spec = self._spec()
        hist = (torch.full((c, engine.cache_len), -1, dtype=torch.int32, device=dev)
                if spec is not None else None)
        modes = [True] + ([False] if spec is not None and spec.adaptive else [])
        for (h, w) in resolutions:
            # (a) the solo init path, at the cache length add_stream uses
            st = engine.new_stream(cache_len=_init_cache_len(engine))
            engine.chunk_step(st, np.zeros((init_frames, h, w, 3), np.uint8), 0.0,
                              init_frames / engine.fps, query, self.gen)
            del st
            # (b) one pool step for this grid class, every slot active
            grid = grid_for_frames(steady_frames, h, w, engine.cfg.vision)
            staged = device_patchify(
                torch.zeros((steady_frames, h, w, 3), dtype=torch.uint8, device=dev))
            vis = engine.vision_aux(grid)
            n_ids = len(engine.tokenizer.encode(self._prompt(3.0, 4.0, grid)))
            ids = torch.zeros((c, _bucket(n_ids)), dtype=torch.int32, device=dev)
            for use_spec in modes:
                self._get_step(use_spec)(
                    engine.model, ids, torch.full((c,), n_ids, dtype=torch.int32, device=dev),
                    scratch, staged.expand((c,) + staged.shape), vis.cos, vis.sin, vis.seg_ids,
                    counts, last, torch.zeros((c,), dtype=torch.int32, device=dev),
                    torch.ones((c,), dtype=torch.bool, device=dev), engine.generator,
                    vis.group, hist)
                # reset so each step sees a fresh-depth pool
                scratch.offset = torch.zeros((c,), dtype=torch.int32, device=dev)
                counts.zero_()
                last.fill_(-1)
                if hist is not None:
                    hist.fill_(-1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if adopt_scratch and self.pool_caches is None:
            # stale K/V contents sit beyond every row's kv_limit (offset 0)
            # and are never attended
            self.pool_caches, self.pool_counts, self.pool_last = scratch, counts, last
            self.pool_hist = hist

    # -- pool management ----------------------------------------------------

    def _ensure_pool(self) -> None:
        if self.pool_caches is not None:
            return
        engine = self.engine
        dev = engine.device
        self.pool_caches = KVCache.zeros(engine.cfg.text, self.capacity, engine.cache_len,
                                         engine.cache_dtype, dev, engine.model.text.tp)
        self.pool_counts = torch.zeros((self.capacity, engine.cfg.text.vocab_size),
                                       dtype=torch.int32, device=dev)
        self.pool_last = torch.full((self.capacity,), -1, dtype=torch.int32, device=dev)
        if self._spec() is not None:
            self.pool_hist = torch.full((self.capacity, engine.cache_len), -1,
                                        dtype=torch.int32, device=dev)

    def _adopt(self, s: Stream) -> None:
        """Move a freshly initialised stream's cache into a pool slot."""
        self._ensure_pool()
        st = s.init_state
        if st.cache.max_len > self.pool_caches.max_len:
            raise RuntimeError("stream cache grew past the pool size; raise cache_len")
        slot = self._free.pop(0)
        _insert_slot(self.pool_caches, self.pool_counts, self.pool_last, slot,
                     st.cache, st.counts, st.last_token, self.pool_hist, st.hist)
        s.slot = slot
        s.rope_delta = st.rope_delta
        s.length_ub = st.length
        s.sink_len = min(st.length, self.compact_sink_cap)
        s.init_state = None

    def _compact(self, s: Stream) -> None:
        """Evict the middle of one stream's cache (sink + recent window kept)."""
        # the device depth, not the host upper bound: the rope_delta fold must
        # keep (offset + delta) invariant exactly
        old_off = int(self.pool_caches.offset[s.slot])
        sink, keep, new_off = plan_compaction(
            old_off, s.sink_len, self.compact_keep, self.pool_caches.max_len)
        if new_off >= old_off:
            return
        self.pool_caches = compact_cache_row(self.pool_caches, s.slot, sink, keep)
        if self.pool_hist is not None:
            compact_token_row(self.pool_hist, old_off, s.slot, sink, keep)
        s.rope_delta += old_off - new_off
        s.length_ub = new_off
        self.engine.metrics.record("cache_compaction_dropped_tokens", float(old_off - new_off))

    # -- execution ---------------------------------------------------------

    def _prompt(self, t0: float, t1: float, grid) -> str:
        """A continuation turn's text: the time span and one video clip."""
        content = [{"type": "text", "text": f"Time={t0:.1f}-{t1:.1f}s"},
                   {"type": "video", "video": None}]
        text = chat.render_chat([{"role": "user", "content": content}],
                                add_generation_prompt=True)
        text = chat.strip_system_for_continuation(text, self.engine.sys_offset)
        return chat.expand_vision_placeholders(text, video_grid_thw=[grid])

    def _collect(self, tokens_dev, n_gen_dev, slot_map: dict, dispatched: float, n_iters_dev,
                 used_spec: bool) -> None:
        """Copy one pool step's tokens to the host and surface each chunk's
        text; feed the step's wall (dispatch to tokens on the host: prefill
        and decode, the same for both modes) to the adaptive controller."""
        metrics = self.engine.metrics
        tokens = tokens_dev.cpu().numpy()            # waits for the device
        n_gen = n_gen_dev.cpu().numpy()
        done = time.perf_counter()
        emitted = int(sum(n_gen[slot] for slot in slot_map))
        self._ctl().observe_wall(used_spec, done - dispatched, emitted)
        if used_spec:
            n_iters = int(n_iters_dev)
            self._ctl().observe(emitted, len(slot_map), n_iters)
            metrics.record("spec_tokens_per_window",
                           emitted / max(len(slot_map), 1) / max(n_iters, 1))
        for slot, (sid, span, sub_ts) in slot_map.items():
            generated = tokens[slot, : int(n_gen[slot])].tolist()
            text = self.engine.tokenizer.decode(generated, skip_special_tokens=True)
            now = time.perf_counter()
            self._streams[sid].outputs.append((span, text, now))
            metrics.record("chunk_e2e_latency", done - dispatched)
            metrics.record("chunk_submit_to_text", now - sub_ts)

    def tick(self) -> int:
        """Run every pending chunk; returns the number run. Each chunk's text
        is on the host when this returns (``drain``)."""
        with self.engine.metrics.measure("serve_tick"):
            return self._tick()

    def _tick(self) -> int:
        ready = [s for s in self._streams.values() if s.pending is not None]
        if not ready:
            return 0
        # init chunks: the single-stream path (3D rope), then adopt into the pool
        for s in [x for x in ready if x.slot is None]:
            frames, t0, t1, sub_ts = s.pending
            s.pending = None
            q = s.query if (s.query and not s.query_sent) else None
            s.query_sent = s.query_sent or q is not None
            text = self.engine.chunk_step(s.init_state, frames, t0, t1, q, self.gen)
            now = time.perf_counter()
            s.outputs.append(((t0, t1), text, now))
            self.engine.metrics.record("chunk_submit_to_text", now - sub_ts)
            self._adopt(s)
        steady = [s for s in ready if s.pending is not None]
        if steady:
            self._run_pool(steady)
        return len(ready)

    def _run_pool(self, streams: list[Stream]) -> None:
        # host prep: tokenize per stream, group by resolution class — each
        # grid class runs its own batched step over the shared slot pool
        preps = []
        for s in streams:
            (staged, grid), t0, t1, sub_ts = s.pending
            s.pending = None
            preps.append({"s": s, "ids": self.engine.tokenizer.encode(self._prompt(t0, t1, grid)),
                          "grid": grid, "staged": staged, "span": (t0, t1), "sub_ts": sub_ts})
        groups: dict[tuple, list[dict]] = {}
        for p in preps:
            groups.setdefault(p["grid"], []).append(p)
        # Bump the host length upper bounds, then guard EVERY adopted row
        # against the largest bucket this tick writes, BEFORE running any
        # group: the batched prefill writes a bucket tile at every pool row's
        # offset (a start past the end clamps downward and would overwrite an
        # idle row's history tail), and a guard failing between two groups
        # would leave the tick half applied.
        max_bucket = 0
        charges: dict[int, int] = {}         # this tick's length growth per sid
        # a verify window writes up to k_draft + 1 KVs past the accepted
        # frontier: reserve that overhang in the guard
        spec_extra = 0 if self._spec() is None else self._spec().k_draft + 1
        for group_preps in groups.values():
            bucket = _bucket(max(len(p["ids"]) for p in group_preps))
            max_bucket = max(max_bucket, bucket)
            for p in group_preps:
                charges[p["s"].sid] = len(p["ids"]) + self.gen.max_new_tokens + spec_extra
        for s in self._streams.values():
            if s.slot is None:
                continue
            need = s.length_ub + charges.get(s.sid, 0) + max_bucket
            # Per-slot staggered threshold: streams that joined together hit
            # the horizon together; compacting all of them in one tick stacks
            # their row rewrites into one latency spike.
            stagger = s.slot * 256 if self.compact_keep else 0
            if self.compact_keep and need > self.pool_caches.max_len - stagger:
                self._compact(s)             # resets length_ub to the device depth
                need = s.length_ub + charges.get(s.sid, 0) + max_bucket
            if need > self.pool_caches.max_len:
                raise RuntimeError("pool cache exhausted; raise engine.cache_len")
        for sid, charge in charges.items():
            self._streams[sid].length_ub += charge
        for grid, group_preps in groups.items():
            self._collect(*self._dispatch(grid, group_preps))

    def _dispatch(self, grid: tuple, preps: list[dict]) -> tuple:
        """One batched prefill + decode over the pool for one resolution class."""
        engine = self.engine
        dev = engine.device
        c = self.capacity
        vis = engine.vision_aux(grid)
        bucket = _bucket(max(len(p["ids"]) for p in preps))
        ready = torch.stack([p["staged"] for p in preps])            # [n, Np, pd]
        patches = ready.new_zeros((c,) + ready.shape[1:])
        patches[torch.tensor([p["s"].slot for p in preps], device=dev)] = ready

        ids = np.zeros((c, bucket), np.int32)
        valid = np.zeros((c,), np.int32)
        deltas = np.zeros((c,), np.int32)
        active = np.zeros((c,), bool)
        slot_map: dict[int, tuple] = {}
        for p in preps:
            s = p["s"]
            slot_map[s.slot] = (s.sid, p["span"], p["sub_ts"])
            ids[s.slot, : len(p["ids"])] = p["ids"]
            valid[s.slot] = len(p["ids"])
            deltas[s.slot] = s.rope_delta
            active[s.slot] = True
        use_spec = self._ctl().use_spec()
        dispatched = time.perf_counter()
        to_dev = lambda a: torch.from_numpy(a).to(dev)
        (tokens, n_gen, self.pool_caches, self.pool_counts, self.pool_last, self.pool_hist,
         n_iters) = self._get_step(use_spec)(
            engine.model, to_dev(ids), to_dev(valid), self.pool_caches, patches,
            vis.cos, vis.sin, vis.seg_ids, self.pool_counts, self.pool_last,
            to_dev(deltas), to_dev(active), engine.generator, vis.group, self.pool_hist,
        )
        return tokens, n_gen, slot_map, dispatched, n_iters, use_spec

"""The port's serving pool against the JAX package's ``StreamServer``.

Both servers get the hf_tiny golden weights (JAX ``convert_state_dict``,
carried across by ``params_from_jax``), the same uint8 frames from a numpy
seed, fp32 models, greedy decoding with repetition penalty 1.05, and an fp32
or int8 KV cache. The JAX server runs its XLA reference path on the CPU and
the port its kernels' plain versions. One function (``drive``) runs the same
traffic through either server: the two have the same public API. The JAX
runs are module-scoped fixtures, shared by the tests that compare with them.
"""

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
from livecc_tpu.serve.scheduler import StreamServer as JaxStreamServer
from livecc_tpu.vision_io.patchify import device_patchify as jax_device_patchify

from livecc_tpu_torch.core.config import tiny_config
from livecc_tpu_torch.data.tokenizer import ByteTokenizer as PortByteTokenizer
from livecc_tpu_torch.engine import GenerationParams, LiveCCEngine
from livecc_tpu_torch.models import qwen2_vl as pm
from livecc_tpu_torch.ops.rope import vision_rotary_cos_sin
from livecc_tpu_torch.serve import StreamServer
from livecc_tpu_torch.vision_io.patchify import device_patchify, grid_for_frames
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "hf_tiny.npz")
T = torch.from_numpy
GEN = dict(max_new_tokens=4, eos_token_id=3, pad_token_id=0, repetition_penalty=1.05)
DTYPES = {"float32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    state = {k[len("state::"):]: g[k] for k in g.files if k.startswith("state::")}
    params = jm.convert_state_dict(state, jax_tiny_config())
    return params, pm.params_from_jax(jax.tree_util.tree_map(np.asarray, params), tiny_config())


def frames(seed, n=2, h=28, w=28):
    return np.random.RandomState(seed).randint(0, 255, size=(n, h, w, 3), dtype=np.uint8)


def jax_server(golden, dtype, cache_len=512, **kw):
    eng = JaxEngine(golden[0], jax_tiny_config(), ByteTokenizer(), cache_len=cache_len,
                    cache_dtype=DTYPES[dtype][0], use_flash=False, quantize_weights=False)
    return JaxStreamServer(eng, JaxGenerationParams(**GEN), **kw)


def port_server(golden, dtype, cache_len=512, **kw):
    eng = LiveCCEngine(golden[1], tiny_config(), PortByteTokenizer(), cache_len=cache_len,
                       cache_dtype=DTYPES[dtype][1])
    return StreamServer(eng, GenerationParams(**GEN), **kw)


# traffic: (tick, stream name, resolution, query, frame seed); a stream's
# first chunk is its 6-frame init chunk
MIXED = [
    (0, "a", (28, 28), "q", 0),
    (1, "a", (28, 28), None, 1), (1, "b", (28, 56), "late", 2),     # b joins late
    (2, "a", (28, 28), None, 3), (2, "b", (28, 56), None, 4),       # mixed resolutions
    (3, "a", (28, 28), None, 5), (3, "b", (28, 56), None, 6),
]
LONG = [(0, "a", (28, 28), "q", 0)] + [(i, "a", (28, 28), None, i) for i in range(1, 11)]


def drive(server, traffic, snapshot_after=None, path=None):
    """Run ``traffic`` through ``server``; returns {stream name: [texts]}.
    With ``snapshot_after`` the server snapshots to ``path`` after that tick."""
    sids, spans, texts = {}, {}, {}
    for tick in sorted({t for t, *_ in traffic}):
        for t, name, res, query, seed in traffic:
            if t != tick:
                continue
            if name not in sids:
                sids[name] = server.add_stream(res, query=query)
                spans[name] = (0.0, 3.0)
                f = frames(seed, 6, *res)
            else:
                spans[name] = (spans[name][1], spans[name][1] + 1.0)
                f = frames(seed, 2, *res)
            server.submit_chunk(sids[name], f, *spans[name])
        server.tick()
        server.flush()
        for name, sid in sids.items():
            texts.setdefault(name, []).extend(text for _, text in server.drain(sid))
        if tick == snapshot_after:
            server.snapshot(path)
    return texts


@pytest.fixture(scope="module")
def jax_mixed(golden):
    return {dtype: drive(jax_server(golden, dtype, capacity=3), MIXED) for dtype in DTYPES}


@pytest.fixture(scope="module")
def jax_long(golden):
    out = {}
    for dtype in DTYPES:
        server = jax_server(golden, dtype, cache_len=256, compact_keep=64, compact_sink_cap=32)
        out[dtype] = (drive(server, LONG),
                      server.engine.metrics.summary("cache_compaction_dropped_tokens"))
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pool_matches_jax(golden, jax_mixed, dtype):
    """Capacity 3 with one slot idle throughout, a stream that joins one
    tick late, and two resolution classes in one pool."""
    server = port_server(golden, dtype, capacity=3)
    out = drive(server, MIXED)
    assert out == jax_mixed[dtype]
    assert len(out["a"]) == 4 and len(out["b"]) == 3
    assert server.pool_caches.quantized == (dtype == "int8")
    assert len(server._free) == 1 and int(server.pool_caches.offset[server._free[0]]) == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pool_session_across_compaction_matches_jax(golden, jax_long, dtype):
    server = port_server(golden, dtype, cache_len=256, compact_keep=64, compact_sink_cap=32)
    out = drive(server, LONG)
    ref, ref_dropped = jax_long[dtype]
    assert out == ref and len(out["a"]) == len(LONG)
    dropped = server.engine.metrics.summary("cache_compaction_dropped_tokens")
    assert dropped["n"] >= 1 and dropped == ref_dropped


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_jax_snapshot_restores_into_port_and_back(golden, jax_mixed, tmp_path, dtype):
    """A JAX snapshot restores into the port and continues with the text the
    JAX server would have given; the port's snapshot of that state has the
    same keys, dtypes and meta, and restores into the JAX server."""
    jax_path, port_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    first, last = MIXED[:5], MIXED[5:]
    drive(jax_server(golden, dtype, capacity=3), first, snapshot_after=2, path=jax_path)
    port = port_server(golden, dtype, capacity=3)
    restored = port.restore(jax_path)
    assert len(restored) == 2
    port.snapshot(port_path)
    a, b = np.load(jax_path), np.load(port_path)
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
    assert b["__meta__"].tobytes() == a["__meta__"].tobytes()
    # continue with the last tick's chunks: the port restored from JAX, JAX
    # restored from JAX, and JAX restored from the port's snapshot
    spans = {"a": (5.0, 6.0), "b": (4.0, 5.0)}
    want = {"a": jax_mixed[dtype]["a"][3:], "b": jax_mixed[dtype]["b"][2:]}
    runs = [(port, restored), (jax_server(golden, dtype, capacity=3), jax_path),
            (jax_server(golden, dtype, capacity=3), port_path)]
    for server, source in runs:
        sids = dict(zip("ab", source if isinstance(source, list) else server.restore(source)))
        for _, name, res, _, seed in last:
            server.submit_chunk(sids[name], frames(seed, 2, *res), *spans[name])
        server.tick()
        server.flush()
        assert {name: [t for _, t in server.drain(sid)] for name, sid in sids.items()} == want


def test_batched_vision_forward_matches_jax_vmap(golden):
    """Per-row clips [B, Np, pd] through ONE port vision-tower call against
    JAX's ``vmap`` over rows; row 2 holds no video placeholder (an idle pool
    slot) and row 0/1 different clips."""
    params, model = golden
    jcfg, cfg = jax_tiny_config(), tiny_config()
    grid = grid_for_frames(2, 56, 28, cfg.vision)
    n_vid = grid[0] * grid[1] * grid[2] // 4
    clips = np.stack([frames(s, 2, 56, 28) for s in (0, 1, 2)])
    row = [10, cfg.vision_start_token_id] + [cfg.video_token_id] * n_vid + [cfg.vision_end_token_id, 11]
    ids = np.zeros((3, len(row) + 3), np.int32)
    ids[0, :len(row)] = row
    ids[1, 2:2 + len(row)] = row
    ids[2, :4] = [12, 13, 14, 15]
    b, s, smax = ids.shape[0], ids.shape[1], 64
    pos = np.broadcast_to(np.arange(s)[None, None], (3, b, s)).astype(np.int32)
    cos, sin = vision_rotary_cos_sin([grid], cfg.vision.head_dim)
    seg = np.repeat(np.arange(grid[0]), grid[1] * grid[2]).astype(np.int32)
    group = grid[1] * grid[2]
    jpatches = jnp.stack([jax_device_patchify(jnp.asarray(c)) for c in clips])
    jvis = jm.VisionInputs(jpatches, jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(seg), group)
    jlogits, _ = jm.forward(params, jcfg, jnp.asarray(ids), jnp.asarray(pos), vision=jvis,
                            cache=jm.KVCache.zeros(jcfg.text, b, smax),
                            attention_mask=jnp.arange(smax)[None, :] < s)
    pvis = pm.VisionInputs(torch.stack([device_patchify(T(c)) for c in clips]), T(cos), T(sin),
                           T(seg), group)
    plogits, _ = pm.forward(model, cfg, T(ids), T(pos), pm.KVCache.zeros(cfg.text, b, smax),
                            vision=pvis)
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    # the same rows one at a time give the same logits (rows never mix)
    solo, _ = pm.forward(model, cfg, T(ids[1:2]), T(pos[:, 1:2]),
                         pm.KVCache.zeros(cfg.text, 1, smax),
                         vision=pm.VisionInputs(pvis.patches[1], T(cos), T(sin), T(seg), group))
    np.testing.assert_allclose(plogits[1:2].numpy(), solo.numpy(), atol=1e-5, rtol=0)


def test_warmup_adopts_scratch_pool_without_state_change(golden):
    """warmup runs the init path and one pool step per resolution on a
    scratch pool that becomes the pool (offsets, counts, markers reset);
    serving after it gives the text a cold server gives."""
    warm = port_server(golden, "int8", capacity=2)
    warm.warmup([(28, 28), (28, 56)])
    assert warm.pool_caches is not None and warm.pool_caches.quantized
    assert not warm.pool_caches.offset.any() and not warm.pool_counts.any()
    assert (warm.pool_last == -1).all()
    traffic = MIXED[:3]
    assert drive(warm, traffic) == drive(port_server(golden, "int8", capacity=2), traffic)


def test_capacity_and_overwrite_guards(golden):
    server = port_server(golden, "float32", capacity=2)
    server.add_stream((28, 28))
    server.add_stream((28, 28))
    with pytest.raises(RuntimeError, match="capacity"):
        server.add_stream((28, 28))
    server = port_server(golden, "float32", cache_len=256, compact_keep=0)
    with pytest.raises(RuntimeError, match="pool cache exhausted"):
        drive(server, LONG)


def test_drain_timed_and_remove_stream(golden):
    """drain_timed stamps each row with the moment its text reached the
    host; chunk_submit_to_text is recorded per chunk; a removed stream frees
    its slot for the next one."""
    import time

    server = port_server(golden, "int8", capacity=2)
    before = time.perf_counter()
    s0 = server.add_stream((28, 28), query="q")
    s1 = server.add_stream((28, 28), query="w")
    for sid, seed in ((s0, 0), (s1, 9)):
        server.submit_chunk(sid, frames(seed, 6), 0.0, 3.0)
    assert server.tick() == 2
    server.submit_chunk(s0, frames(1), 3.0, 4.0)
    server.submit_chunk(s1, frames(2), 3.0, 4.0)
    assert server.tick() == 2
    after = time.perf_counter()
    rows = server.drain_timed(s0)
    assert [span for span, _, _ in rows] == [(0.0, 3.0), (3.0, 4.0)]
    assert all(before <= ts <= after for _, _, ts in rows) and rows[0][2] <= rows[1][2]
    m = server.engine.metrics.summary()
    assert m["chunk_submit_to_text"]["n"] == 4 and m["serve_tick"]["n"] == 2
    assert m["chunk_e2e_latency"]["n"] == 2
    slot = server._streams[s1].slot
    server.remove_stream(s1)
    s2 = server.add_stream((28, 28), query="c")
    server.submit_chunk(s2, frames(3, 6), 0.0, 3.0)
    assert server.tick() == 1 and server._streams[s2].slot == slot

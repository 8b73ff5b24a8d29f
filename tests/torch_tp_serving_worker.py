"""One rank of the multi-process cases of ``tests/test_torch_tp_serving.py``.

    python tests/torch_tp_serving_worker.py RANK WORLD N_DATA N_MODEL IO_DIR

The ranks meet over gloo at ``file://IO_DIR/rendezvous``. ``IO_DIR/args.pkl``
holds the inputs (numpy arrays, lists, dicts: nothing that needs JAX to
unpickle) and the names of the cases to run, in order; each rank runs every
case on its own model (built from the JAX param tree by
``params_from_jax``, then ``shard_params``), and rank 0 writes every rank's
results to ``IO_DIR/out.pt`` as a list indexed by rank. Imports torch and
the port only, and checks at the end that JAX was never imported.

The drives (``frames``, ``engine_chunks``, ``pool_ticks``) are also the
test's: the JAX engine and pool have the same public API, so one function
runs the same traffic through any of them.
"""

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from livecc_tpu_torch.core.config import tiny_config  # noqa: E402
from livecc_tpu_torch.core.mesh import make_mesh  # noqa: E402
from livecc_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from livecc_tpu_torch.engine import GenerationParams, LiveCCEngine  # noqa: E402
from livecc_tpu_torch.engine.speculative import SpecConfig, SpecController  # noqa: E402
from livecc_tpu_torch.models import qwen2_vl as pm  # noqa: E402
from livecc_tpu_torch.ops.quant import quantize_model  # noqa: E402
from livecc_tpu_torch.parallel.sharding import shard_params  # noqa: E402
from livecc_tpu_torch.parallel.tp import TensorParallel  # noqa: E402
from livecc_tpu_torch.serve import StreamServer  # noqa: E402

# the generation of JAX's tests/test_tp_serving.py (greedy, 4 tokens a chunk)
GEN = dict(max_new_tokens=4, eos_token_id=3, pad_token_id=0)
SAMPLE = dict(GEN, do_sample=True, temperature=0.8, top_k=40)
# an engine whose cache reaches its ceiling and compacts within 6 chunks
COMPACT = dict(cache_len=256, compact_keep=64, compact_sink_cap=32)
ENGINE_CHUNKS = 6
SPEC = dict(k_draft=3, adaptive=False)


def frames(seed, n=2, h=28, w=28):
    return np.random.RandomState(seed).randint(0, 255, size=(n, h, w, 3), dtype=np.uint8)


def engine_chunks(engine, gen, n_chunks, seed=0, query="q"):
    """One stream: a 6-frame chunk over 0-3 s with ``query``, then 2-frame
    chunks of 1 s (``tests/test_tp_serving.py:74``'s drive for 2 chunks).
    Returns (texts, the stream's state)."""
    st = engine.new_stream()
    out = [engine.chunk_step(st, frames(seed, 6), 0.0, 3.0, query, gen)]
    for i in range(1, n_chunks):
        out.append(engine.chunk_step(st, frames(seed + i), 2.0 + i, 3.0 + i, None, gen))
    return out, st


def pool_ticks(server, ticks, sids=None, start=0):
    """Two streams ("q" and "w") through ``server``: their 6-frame chunks at
    tick 0, then one 2-frame chunk each a tick (``tests/test_tp_serving.py:
    39``'s drive for 2 ticks). ``sids`` continues restored streams from
    tick ``start``. Returns (each stream's texts, the sids)."""
    if sids is None:
        sids = [server.add_stream((28, 28), query=q) for q in ("q", "w")]
    for t in range(start, start + ticks):
        for sid, seed in zip(sids, (t, 9 - t)):
            if t == 0:
                server.submit_chunk(sid, frames(seed, 6), 0.0, 3.0)
            else:
                server.submit_chunk(sid, frames(seed), 2.0 + t, 3.0 + t)
        server.tick()
    server.flush()
    return [[text for _, text in server.drain(sid)] for sid in sids], sids


def split_model(args, mesh, w8=False, tree="params"):
    """The tiny model from the JAX tree, quantized whole where ``w8`` (as
    JAX quantizes before it shards), then this rank's shard."""
    cfg = tiny_config()
    model = pm.params_from_jax(args[tree], cfg)
    if w8:
        quantize_model(model)
    shard_params(model, cfg, mesh)
    return cfg, model


def engine(cfg, model, **kw):
    return LiveCCEngine(model, cfg, ByteTokenizer(), **kw)


def case_engine(mesh, args):
    """The engine across compaction, and the same split model with lookahead."""
    cfg, model = split_model(args, mesh)
    eng = engine(cfg, model, **COMPACT)
    texts, st = engine_chunks(eng, GenerationParams(**GEN), ENGINE_CHUNKS)
    spec = engine(cfg, model, spec=SpecConfig(**SPEC), **COMPACT)
    spec_texts, _ = engine_chunks(spec, GenerationParams(**GEN), ENGINE_CHUNKS)
    return {"texts": texts, "logits": st.logits, "dropped": eng._dropped,
            "cache_heads": st.cache.k.shape[2], "spec_texts": spec_texts,
            "windows": sum(c.windows for c in spec.chunk_log)}


def case_w8(mesh, args):
    """int8 weights through the engine, and the uncached int8 forward."""
    cfg, model = split_model(args, mesh, w8=True)
    texts, _ = engine_chunks(engine(cfg, model, cache_len=256), GenerationParams(**GEN), 2)
    cfg, qmodel = split_model(args, mesh, tree="qparams")
    with torch.no_grad():
        logits, _ = pm.forward(qmodel, cfg, torch.from_numpy(args["ids"]),
                               torch.from_numpy(args["pos"]))
    return {"texts": texts, "forward": logits}


def case_pool(mesh, args):
    """The int8-KV pool over two ticks."""
    cfg, model = split_model(args, mesh)
    server = StreamServer(engine(cfg, model, cache_len=256, cache_dtype=torch.int8),
                          GenerationParams(**GEN), capacity=2)
    texts, _ = pool_ticks(server, 2)
    return {"texts": texts, "cache_heads": server.pool_caches.k.shape[2]}


def case_snapshot(mesh, args):
    """An fp32 pool snapshotted after two ticks, restored into a new split
    pool and served one more tick."""
    cfg, model = split_model(args, mesh)
    path = os.path.join(args["io"], "snapshot.npz")
    server = StreamServer(engine(cfg, model, cache_len=256), GenerationParams(**GEN), capacity=2)
    texts, _ = pool_ticks(server, 2)
    server.snapshot(path)
    fresh = StreamServer(engine(cfg, model, cache_len=256), GenerationParams(**GEN), capacity=2)
    after, _ = pool_ticks(fresh, 1, sids=fresh.restore(path), start=2)
    return {"texts": texts, "after": after}


def case_sampling(mesh, args):
    cfg, model = split_model(args, mesh)
    texts, st = engine_chunks(engine(cfg, model, cache_len=256), GenerationParams(**SAMPLE), 3)
    return {"texts": texts, "past_ids": st.past_ids}


def case_logits(mesh, args):
    """A cached prefill of two rows, then a continuation of 5 tokens."""
    cfg, model = split_model(args, mesh)
    cache = pm.KVCache.zeros(cfg.text, 2, 64, tp=model.text.tp)
    out = []
    with torch.no_grad():
        for ids, pos in args["chunks"]:
            logits, cache = pm.forward(model, cfg, torch.from_numpy(ids), torch.from_numpy(pos),
                                       cache)
            out.append(logits)
    return {"logits": out, "cache_heads": cache.k.shape[2]}


def case_controller(mesh, args):
    """Walls that differ by rank: rank 0 finds lookahead faster, rank 1 plain.
    The choices with the model group's agreement, and without it."""
    tp = TensorParallel(mesh.model_group, mesh.m, mesh.n_model)
    spec = SpecConfig(k_draft=3, adaptive=True, probe_every=4)
    fast = mesh.m == 0
    walls = {True: 1.0 if fast else 3.0, False: 2.0}
    out = {}
    for name, ctl in (("agreed", SpecController(spec, tp)), ("alone", SpecController(spec))):
        choices = []
        for _ in range(args["dispatches"]):
            choices.append(ctl.use_spec())
            ctl.observe_wall(choices[-1], walls[choices[-1]], 10)
        out[name] = choices
    return out


def case_groups(mesh, args):
    """Each data rank's model group serves a stream of its own, one chunk
    more on data rank 1, so a collective crossing the data axis would part
    the groups' sequences."""
    cfg, model = split_model(args, mesh)
    texts, _ = engine_chunks(engine(cfg, model, cache_len=256), GenerationParams(**GEN),
                             2 + mesh.d, seed=10 * mesh.d, query=("q", "w")[mesh.d])
    return {"texts": texts, "d": mesh.d, "m": mesh.m}


CASES = {"engine": case_engine, "w8": case_w8, "pool": case_pool, "snapshot": case_snapshot,
         "sampling": case_sampling, "logits": case_logits, "controller": case_controller,
         "groups": case_groups}


def main():
    rank, world, n_data, n_model = (int(x) for x in sys.argv[1:5])
    io_dir = sys.argv[5]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(io_dir, 'rendezvous')}",
                            rank=rank, world_size=world)
    mesh = make_mesh(n_data, n_model, "cpu")
    with open(os.path.join(io_dir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    args["io"] = io_dir
    out = {case: CASES[case](mesh, args) for case in args["cases"]}
    every = [None] * world
    dist.all_gather_object(every, out)
    dist.destroy_process_group()
    if "jax" in sys.modules:
        raise SystemExit("torch_tp_serving_worker: jax was imported")
    if rank == 0:
        torch.save(every, os.path.join(io_dir, "out.pt"))


if __name__ == "__main__":
    main()

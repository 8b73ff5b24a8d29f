"""Where the time goes on one GPU: a streaming session, or a serving-pool tick.

    python3 -m livecc_tpu_torch.tools.profile_stream          # single stream
    python3 -m livecc_tpu_torch.tools.profile_stream --pool   # one pool tick
    ... --spec        # either with lookahead decoding (session.SPEC, controller off)
    ... --adaptive    # either with lookahead under the adaptive controller
    ... --w8          # either with int8 matmul weights (K5, ops/quant.py)

Both use the 7B definitions of ``livecc_tpu_torch.tools.session`` (the ones
``chip_smoke.py`` drives).

  * single stream: runs the session ``UNPROFILED_SESSIONS`` times (the
    first warms up) and prints each wall, then once more under
    ``torch.profiler`` (CUDA activity only: the kernels, without the host
    ops' events, which cost minutes to collect for an eager session);
  * ``--pool``: 8 streams join the int8 serving pool and run their init
    chunks and all but the last steady tick unprofiled; the last steady tick
    (one batched prefill + decode at B = 8) runs under the profiler.

It prints each chunk's or tick's wall time (with ``--spec``, its verify
windows), the decode graphs' captures (count and seconds), decode replays
and window replays where the checkout has them (with ``--adaptive``, the
mode the controller chose at each dispatch and its two per-token costs), the device's
busy time (union of kernel intervals) against the wall time, i.e. the
device's idle share; and device time by group — the port's kernels (K3 ViT attention, K1 prefill and
K2 decode attention, and their int8 variants; K5, the int8-weight GEMM
of ``--w8``; K4 training attention for
``tools/train_session.py --profile``, which reuses ``report``), matrix
products, everything else — and the top kernels by name.

Needs a CUDA GPU; it does not run on the CPU. To profile another checkout
of the port with this script, run it by path with that checkout first on
``PYTHONPATH``; it also groups the one-kernel decode (``decode_kernel``)
that came before the split-KV kernels.
"""

from __future__ import annotations

import argparse
import collections
import re
import time

import torch

UNPROFILED_SESSIONS = 3


def _group(name: str) -> str:
    if re.search(r"train_fwd(_mma)?_kernel", name):            # fp32 and bf16 K4
        return "K4 train_attention_fwd"
    if re.search(r"train_(dkv|dq)(_mma)?_kernel", name):
        return "K4 train_attention_bwd"
    if re.search(r"w8_(small|merge|large|wgmma|fma)_kernel", name):   # K5
        return "K5 w8a16_gemm"
    if "quant_mma_attention_kernel" in name:                     # bf16 K1-int8
        return "K1-int8 flash_prefill_int8"
    m = re.search(r"mma_attention_kernel<(true|false)", name)     # bf16 K1 / K3
    if m:
        return "K1 flash_prefill" if m.group(1) == "true" else "K3 vit_group_attention"
    m = re.search(r"(tile_attention_kernel|decode_kernel|decode_split_kernel|decode_merge_kernel)"
                  r"<[^,>]+, *(true|false)(?:, *(true|false|\d+))?", name)
    if m:
        kernel, flag, quant = m.groups()
        if kernel != "tile_attention_kernel":       # K2's split and merge kernels
            return "K2-int8 flash_decode_int8" if flag == "true" else "K2 flash_decode"
        if flag == "false":
            return "K3 vit_group_attention"
        return "K1-int8 flash_prefill_int8" if quant == "true" else "K1 flash_prefill"
    low = name.lower()
    if any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet", "gemv", "splitk")):
        return "matmul"
    return "other"


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def _kernels(prof) -> list:
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_seconds(prof) -> float:
    """The device's busy time in a profile: the union of its kernels' intervals."""
    return _busy_us([(e.time_range.start, e.time_range.end) for e in _kernels(prof)]) / 1e6


def print_graph_stats(model, label: str = "") -> None:
    """Print the decode graphs' captures and replays on ``model`` since
    their last reset, then reset them; nothing for a checkout without them."""
    try:
        from livecc_tpu_torch.engine.graphs import graphs_for
    except ImportError:
        return
    graphs = graphs_for(model, model.cfg)
    st = graphs.stats()
    graphs.reset_stats()
    print(f"{label}decode graphs: {st['captures']} captures in {st['capture_seconds']:.3f} s, "
          f"{st['replays']} replays, {st.get('windows', 0)} window replays, "
          f"{st['host_reads']} host reads")


def log_choices(ctl) -> list:
    """The modes ``ctl`` (a ``SpecController``) chooses from now on, as a list
    that grows with each dispatch."""
    choices = []
    use = ctl.use_spec

    def logged():
        choices.append(use())
        return choices[-1]

    ctl.use_spec = logged
    return choices


def print_choices(label: str, ctl, choices: list) -> None:
    spt = {k: None if v is None else round(v * 1e3, 3) for k, v in ctl.spt.items()}
    print(f"{label}controller: modes " + " ".join("L" if c else "P" for c in choices)
          + f" (L lookahead, P plain); ms per emitted token: lookahead {spt[True]}, plain "
            f"{spt[False]}; tokens a window EMA {ctl.ema}")


def device_groups(prof) -> dict[str, float]:
    """Device seconds of a profile's kernels by group (the port's kernels,
    matmul, other)."""
    by_group: dict[str, float] = collections.defaultdict(float)
    for e in _kernels(prof):
        by_group[_group(e.name)] += (e.time_range.end - e.time_range.start) / 1e6
    return dict(by_group)


def report(prof, wall: float) -> None:
    """Device busy time, idle share and device time by group of a profile."""
    kernels = _kernels(prof)
    busy = busy_seconds(prof)
    by_group = device_groups(prof)
    by_name: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e6
        by_name[e.name][1] += 1
    total = sum(by_group.values())
    print(f"wall {wall:.3f} s  device busy {busy:.3f} s  idle share "
          f"{1 - busy / wall:.3f}  kernels launched {len(kernels)}")
    for g, t in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g:28s} {t * 1e3:10.2f} ms  {t / total:6.1%} of device time")
    print("top kernels by device time:")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t * 1e3:10.2f} ms  x{n:5d}  {name[:110]}")


def _engine(sess, cfg, model, spec):
    """A session engine; with ``spec``, one whose controller logs its modes."""
    if spec is None:
        return sess.new_engine(cfg, model), None
    from livecc_tpu_torch.engine import SpecController

    eng = sess.new_engine(cfg, model, spec)
    eng._spec_ctl = SpecController(spec)
    return eng, log_choices(eng._spec_ctl)


def profile_session(cfg, model, spec=None) -> None:
    from torch.profiler import ProfilerActivity, profile

    from livecc_tpu_torch.tools import session as sess

    frames = sess.main_frames()

    def run(eng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.run_session(eng, frames)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for i in range(UNPROFILED_SESSIONS):
        eng, choices = _engine(sess, cfg, model, spec)
        print(f"session {i} wall {run(eng):.3f} s (unprofiled{', warm-up' if i == 0 else ''})"
              + ("" if spec is None else "; windows a chunk "
                 + str([rec.windows for rec in eng.chunk_log])))
        print_graph_stats(model)
        if spec is not None and spec.adaptive:
            print_choices("", eng._spec_ctl, choices)
    eng, choices = _engine(sess, cfg, model, spec)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = run(eng)
    for rec in eng.chunk_log:
        print(f"chunk wall {rec.seconds * 1e3:9.2f} ms  prompt {rec.prompt_tokens:4d}  "
              f"generated {rec.generated_tokens:2d}"
              + ("" if spec is None else f"  windows {rec.windows:2d}"))
    print_graph_stats(model)
    if spec is not None and spec.adaptive:
        print_choices("", eng._spec_ctl, choices)
    report(prof, wall)


def profile_pool_tick(cfg, model, spec=None) -> None:
    from torch.profiler import ProfilerActivity, profile

    from livecc_tpu_torch.tools import session as sess

    server = sess.pool_server(cfg, model, spec=spec)
    choices = log_choices(server._ctl()) if spec is not None else []
    server.warmup([(sess.HEIGHT, sess.WIDTH)])
    print_graph_stats(model, "warmup: ")
    # init chunks and all steady ticks but the last, unprofiled
    _, walls = sess.run_pool(server, steady_ticks=sess.POOL_STEADY_TICKS - 1)
    for i, w in enumerate(walls):
        print(f"tick {i} wall {w * 1e3:9.2f} ms (unprofiled)")
    print_graph_stats(model)
    if spec is not None:
        tpw = server.engine.metrics.summary("spec_tokens_per_window")
        print(f"tokens a window per stream, pool ticks so far: {tpw}")
    sids = sorted(server._streams)
    hi = sess.INIT_FRAMES + sess.STEADY_FRAMES * sess.POOL_STEADY_TICKS
    lo = hi - sess.STEADY_FRAMES
    fps = server.engine.fps
    for i, sid in enumerate(sids):
        clip = sess.synth_frames(hi, sess.HEIGHT, sess.WIDTH, sess.SEED + i)[lo:hi]
        server.submit_chunk(sid, clip, lo / fps, hi / fps)
    depth = server.pool_caches.offset.tolist()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = {sid: server.drain(sid) for sid in sids}
    print(f"profiled tick: B={len(sids)} steady chunks, cache depths before it {depth}, "
          f"{sum(len(r) for r in rows.values())} chunks of text")
    print_graph_stats(model)
    if spec is not None and spec.adaptive:
        print_choices("pool ", server._ctl(), choices)
    report(prof, wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pool", action="store_true",
                    help="profile one steady tick of the 8-stream int8 pool")
    ap.add_argument("--spec", action="store_true",
                    help="decode by lookahead (tools/session.py SPEC: 8 drafts, controller off)")
    ap.add_argument("--adaptive", action="store_true",
                    help="decode by lookahead under the adaptive controller, logging its modes")
    ap.add_argument("--w8", action="store_true",
                    help="int8 matmul weights (tools/session.py main_model(w8=True), K5)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_stream: needs a CUDA GPU")

    import dataclasses

    from livecc_tpu_torch.tools import session as sess

    spec = None
    if args.spec or args.adaptive:
        spec = dataclasses.replace(sess.SPEC, adaptive=args.adaptive)
    cfg, model = sess.main_model(w8=args.w8) if args.w8 else sess.main_model()
    (profile_pool_tick if args.pool else profile_session)(cfg, model, spec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

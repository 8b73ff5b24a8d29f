"""Benchmark harness entry points (the reference's per-benchmark scripts), on the port.

Port of ``livecc_tpu/eval/cli.py``. Usage:
  python -m livecc_tpu_torch.eval.cli videomme --benchmark vm.jsonl --output_dir out \\
      --model /ckpts/LiveCC-7B-Instruct [--with_subtitles] \\
      [--worker 0 --num_workers 8] [--batch_size 4] [--device cuda|cpu]
  python -m livecc_tpu_torch.eval.cli mvbench|ovobench|livesports3kqa ...
  python -m livecc_tpu_torch.eval.cli livesports3kcc --events events.jsonl ...

Replaces the reference's torchrun-per-benchmark scripts
(evaluation/videomme/distributed_evaluate_videomme.py etc.): run one process
per worker (any launcher) with --worker/--num_workers — shards are stride-
partitioned, written idempotently, and the last finishing worker merges and
writes the report. With --model the HF checkpoint loads in bf16
(``load_checkpoint``); without it a tiny random-init model smoke-runs the
full path in fp32. The model runs on the card unless --device cpu asks for
the CPU (the kernels' plain versions); without CUDA, --device cuda raises.
"""

from __future__ import annotations

import argparse
import json


def build_predictor(model_path: str | None, max_frames: int = 64, device: str = "cuda"):
    """An ``MCQPredictor`` on ``device`` for the checkpoint at ``model_path``
    (or the tiny smoke model)."""
    import torch

    from livecc_tpu_torch.core.config import tiny_config
    from livecc_tpu_torch.data.tokenizer import ByteTokenizer, HFTokenizer
    from livecc_tpu_torch.eval.mcq import MCQPredictor
    from livecc_tpu_torch.models.qwen2_vl.convert import load_checkpoint
    from livecc_tpu_torch.models.qwen2_vl.model import init_params
    from livecc_tpu_torch.utils.device import device_for

    device_for(device, "eval.cli", " (--device cpu runs the plain versions on the CPU)")
    if model_path:
        cfg, model = load_checkpoint(model_path, device, torch.bfloat16)
        tokenizer = HFTokenizer(model_path)
    else:
        cfg = tiny_config()
        model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device,
                            torch.float32)
        tokenizer = ByteTokenizer()
    return MCQPredictor(model, cfg, tokenizer, max_frames=max_frames)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("task", choices=[
        "videomme", "mvbench", "ovobench", "livesports3kqa", "livesports3kcc"])
    parser.add_argument("--benchmark", help="benchmark JSONL (MCQ tasks)")
    parser.add_argument("--events", help="events JSONL (livesports3kcc)")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--model", default=None, help="HF checkpoint dir")
    parser.add_argument("--with_subtitles", action="store_true")
    parser.add_argument("--worker", type=int, default=0)
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--max_frames", type=int, default=64)
    parser.add_argument("--max_new_tokens", type=int, default=32)
    parser.add_argument("--device", default="cuda",
                        help="where the model runs: cuda (the kernels) or cpu (their plain "
                             "versions)")
    args = parser.parse_args(argv)

    from livecc_tpu_torch.eval import livesports3kcc, livesports3kqa, mvbench, ovobench, videomme

    if args.task == "livesports3kcc":
        import numpy as np

        from livecc_tpu_torch.demo.cli import build_engine
        from livecc_tpu_torch.vision_io.budget import strict_fps_sample
        from livecc_tpu_torch.vision_io.video_reader import VideoReader

        engine = build_engine(args.model, device=args.device)

        def read_clip(event):
            """[begin, end] event window at strict 2 fps, budget-resized
            (reference distributed_generate_livecc.py:84-89 input contract)."""
            reader = VideoReader(event["video"])
            pts = reader.pts_seconds
            lo = float(event.get("begin", pts[0]))
            hi = float(event.get("end", pts[-1]))
            base = np.where((pts >= lo) & (pts <= hi))[0]
            if len(base) == 0:
                base = np.array([int(np.argmin(np.abs(pts - lo)))])
            idxs, _ = strict_fps_sample(pts[base], budget=engine.budget)
            h, w = reader.frame_size
            rh, rw = engine.budget.spatial_target(h, w, nframes=max(len(idxs), 1))
            return reader.get_batch(base[idxs], out_hw=(rh, rw))

        with open(args.events) as f:
            events = [json.loads(l) for l in f if l.strip()]
        merged = livesports3kcc.generate(
            engine, events, args.output_dir, read_clip=read_clip,
            worker=args.worker, num_workers=args.num_workers,
            max_new_tokens=args.max_new_tokens,
        )
        print(merged or "shard done; other workers pending")
        return merged

    predictor = build_predictor(args.model, max_frames=args.max_frames, device=args.device)
    common = dict(worker=args.worker, num_workers=args.num_workers,
                  batch_size=args.batch_size)
    if args.task == "videomme":
        report = videomme.run(predictor, args.benchmark, args.output_dir,
                              with_subtitles=args.with_subtitles, **common)
    elif args.task == "mvbench":
        report = mvbench.run(predictor, args.benchmark, args.output_dir, **common)
    elif args.task == "ovobench":
        report = ovobench.run(predictor, args.benchmark, args.output_dir, **common)
    else:
        report = livesports3kqa.run(predictor, args.benchmark, args.output_dir, **common)
    print(json.dumps(report) if report else "shard done; other workers pending")
    return report


if __name__ == "__main__":
    main()

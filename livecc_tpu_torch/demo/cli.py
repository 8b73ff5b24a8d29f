"""CLI streaming-commentary demo (reference demo/cli.py), on the port.

Port of ``livecc_tpu/demo/cli.py``. Simulates wall-clock playback: every
simulated second the live engine is told the new playback position and
emits commentary for any newly available 2-frame chunks; the result dumps to
JSON ({video_path, query, commentaries}).

Usage:
  python -m livecc_tpu_torch.demo.cli --video clip.mp4 --query "..." \\
      [--model /path/to/hf_checkpoint] [--seconds 30] [--output out.json] \\
      [--device cuda|cpu] [--quantize-weights]

With --model the HF checkpoint loads in bf16 (``load_checkpoint``) with a
bf16 KV cache and the checkpoint's tokenizer.json. Without it a tiny
random-init config and a byte tokenizer run the whole pipeline in fp32
(smoke mode; the output is gibberish by construction). --quantize-weights
serves int8 matmul weights (JAX's TPU serving configuration; off by
default on every device here). The model runs on
the card unless --device cpu asks for the CPU (the plain versions of the
kernels); without CUDA, --device cuda raises.
"""

from __future__ import annotations

import argparse
import json


def build_engine(model_path: str | None, cache_len: int = 8192, speculative: bool = False,
                 device: str = "cuda", tokenizer=None, quantize_weights: bool | None = None):
    """A ``LiveCCEngine`` on ``device`` for the checkpoint at ``model_path``
    (or the tiny smoke model); ``tokenizer`` overrides the checkpoint's.
    ``quantize_weights`` goes to the engine, which quantizes the loaded
    model module by module (int8 weights through K5; None is off)."""
    import torch

    from livecc_tpu_torch.core.config import tiny_config
    from livecc_tpu_torch.data.tokenizer import ByteTokenizer, HFTokenizer
    from livecc_tpu_torch.engine import LiveCCEngine, SpecConfig
    from livecc_tpu_torch.models.qwen2_vl.convert import load_checkpoint
    from livecc_tpu_torch.models.qwen2_vl.model import init_params
    from livecc_tpu_torch.utils.device import device_for

    device_for(device, "demo.cli", " (--device cpu runs the plain versions on the CPU)")
    if model_path:
        cfg, model = load_checkpoint(model_path, device, torch.bfloat16)
        tokenizer = tokenizer or HFTokenizer(model_path)
        cache_dtype = torch.bfloat16
    else:
        cfg = tiny_config()
        model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device,
                            torch.float32)
        tokenizer = tokenizer or ByteTokenizer()
        cache_dtype = torch.float32
    spec = SpecConfig() if speculative else None
    return LiveCCEngine(model, cfg, tokenizer, cache_len=cache_len, cache_dtype=cache_dtype,
                        quantize_weights=quantize_weights, spec=spec)


def generation_params(engine, max_new_tokens: int = 16, eos_base_threshold: float = 0.0,
                      eos_threshold_step: float = 0.0):
    """The demo's decoding settings: greedy, repetition penalty 1.05, and the
    ' ...' continuation marker (reference demo/infer.py:49) thresholded
    unless ``eos_base_threshold`` < 0."""
    from livecc_tpu_torch.engine import GenerationParams

    streaming_eos = engine.tokenizer.encode(" ...")[-1]
    return GenerationParams(
        max_new_tokens=max_new_tokens,
        eos_token_id=engine.cfg.eos_token_id,
        pad_token_id=engine.cfg.pad_token_id,
        repetition_penalty=1.05,
        streaming_eos_token_id=streaming_eos if eos_base_threshold >= 0 else -1,
        streaming_threshold_base=eos_base_threshold,
        streaming_threshold_step=eos_threshold_step,
    )


def commentate(live, video, seconds: int, query: str, gen) -> list[list]:
    """Play ``video`` through ``live`` (a ``LiveCC``) one simulated second
    at a time for ``seconds`` seconds: [t0, t1, text] per chunk."""
    session = live.open(video)
    commentaries = []
    for t in range(seconds + 1):
        for (t0, t1), text in live.live_cc(session, float(t), query=query, gen=gen):
            commentaries.append([t0, t1, text])
            print(f"[{t0:5.1f}-{t1:5.1f}s] {text}")
        if session.video_end:
            break
    return commentaries


def main(argv=None, *, tokenizer=None):
    """Run the demo; returns the result dict. ``tokenizer`` goes to
    ``build_engine``."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--video", required=True)
    parser.add_argument("--query", default="Please describe the video.")
    parser.add_argument("--model", default=None, help="HF checkpoint dir (safetensors + tokenizer.json)")
    parser.add_argument("--seconds", type=int, default=30)
    parser.add_argument("--max-new-tokens", type=int, default=16)
    parser.add_argument("--output", default=None)
    parser.add_argument("--streaming-eos-base-threshold", type=float, default=0.0)
    parser.add_argument("--streaming-eos-threshold-step", type=float, default=0.0)
    parser.add_argument("--quantize-weights", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="int8 matmul weights (half the weight bytes; ops/quant.py, the "
                             "W8A16 kernel K5). Default: off on every device until the port's "
                             "benchmark has A/B'd it")
    parser.add_argument("--speculative", action="store_true",
                        help="fused on-device lookahead decoding (n-gram drafts verified in "
                             "one forward; engine/speculative.py)")
    parser.add_argument("--device", default="cuda",
                        help="where the model runs: cuda (the kernels) or cpu (their plain "
                             "versions)")
    args = parser.parse_args(argv)

    from livecc_tpu_torch.engine.live import LiveCC

    engine = build_engine(args.model, speculative=args.speculative, device=args.device,
                          tokenizer=tokenizer, quantize_weights=args.quantize_weights)
    gen = generation_params(engine, args.max_new_tokens, args.streaming_eos_base_threshold,
                            args.streaming_eos_threshold_step)
    commentaries = commentate(LiveCC(engine), args.video, args.seconds, args.query, gen)
    result = {"video_path": args.video, "query": args.query, "commentaries": commentaries}
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {args.output}")
    return result


if __name__ == "__main__":
    main()

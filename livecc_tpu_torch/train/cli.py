"""Training entry point (reference train.py equivalent), on the port.

Port of ``livecc_tpu/train/cli.py``. Usage:

  python -m livecc_tpu_torch.train.cli \\
      --annotation_paths pt.jsonl sft.jsonl \\
      --pretrained /path/to/hf_checkpoint \\
      --output_dir out --learning_rate 2e-5 --total_steps 1000 \\
      --accum_steps 64 --freeze_modules visual [--device cuda|cpu]

Loads the model from an HF checkpoint dir (config.json + safetensors +
tokenizer.json) in bf16, freezes the named modules (default: the visual
tower, reference train.py:17-19), builds the seek-indexed streaming dataset
(``data/lmm_dataset.py``; a corpus gets its index line from
``write_seek_index``) and runs the single-GPU ``Trainer`` with
resume-by-default (train.py:29 semantics: the latest ``ckpt/<step>/state.pt``
under ``--output_dir``). Without ``--pretrained`` a tiny random-init config
(fp32, drawn on the CPU from seed 0) and a byte tokenizer run the whole
pipeline (smoke mode). The model trains on the card unless ``--device cpu``
asks for the CPU (the kernels' plain versions); without CUDA, ``--device
cuda`` raises.

Multi-device training runs one process a card under torchrun:

  torchrun --nproc_per_node N -m livecc_tpu_torch.train.cli --mesh DxM ...

D x M = N ranks: data parallelism over D (ZeRO-2: the AdamW state split
over it), tensor parallelism over M (Megatron's layout, the vocab-parallel
CE); NCCL on ``--device cuda`` (rank r on ``cuda:LOCAL_RANK``), gloo on
``--device cpu``. Rank 0 logs and saves; the checkpoint is the single-card
``state.pt`` and resumes on any mesh. ``--seq_shard`` adds sequence
parallelism over the model axis (Megatron SP: the residual stream sharded
along the sequence, ``models/qwen2_vl/text.py``); as in JAX it needs
``--mesh DATAxMODEL`` with MODEL >= 2 and exits with code 2 otherwise.
Pipeline parallelism has no flag, as in JAX: a script calls
``parallel/pipeline.py:make_pp_train_step``.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--annotation_paths", nargs="+", required=True)
    parser.add_argument("--pretrained", default=None,
                        help="HF checkpoint dir; omit for tiny random init (smoke)")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--learning_rate", type=float, default=2e-5)
    parser.add_argument("--warmup_ratio", type=float, default=0.03)
    parser.add_argument("--total_steps", type=int, default=1000)
    parser.add_argument("--accum_steps", type=int, default=64)
    parser.add_argument("--save_steps", type=int, default=1000)
    parser.add_argument("--log_steps", type=int, default=10)
    parser.add_argument("--freeze_modules", nargs="*", default=["visual"])
    parser.add_argument("--ce_sup_bucket", type=int, default=None,
                        help="static cap on supervised tokens per micro-batch; compacts the "
                             "vocab CE to supervised positions only (TrainConfig.ce_sup_bucket)")
    parser.add_argument("--adam_mu_dtype", choices=["fp32", "bf16"], default="fp32",
                        help="Adam first-moment dtype; bf16 halves that buffer "
                             "(fp32 matches DeepSpeed)")
    parser.add_argument("--with_context", action="store_true")
    parser.add_argument("--dataloader_num_workers", type=int, default=4,
                        help="per-sample load threads in the prefetch "
                             "(reference: --dataloader_num_workers 16)")
    parser.add_argument("--overwrite_output_dir", action="store_true",
                        help="start fresh instead of resuming (train.py:29)")
    parser.add_argument("--seq_shard", action="store_true",
                        help="sequence parallelism under a TP mesh (Megatron SP over the "
                             "model axis; needs --mesh DATAxMODEL with MODEL >= 2)")
    parser.add_argument("--pack_seq", type=int, default=None,
                        help="sequence packing: pack variable-length samples into rows of "
                             "this many tokens (segment-id attention)")
    parser.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                        help="train over DATA x MODEL ranks under torchrun (one process a "
                             "card): data parallelism with ZeRO-2 over DATA, tensor "
                             "parallelism over MODEL, e.g. 4x2 on 8 cards")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels; the default) or cpu (their plain versions)")
    args = parser.parse_args(argv)
    if args.seq_shard:
        model_ax = int(args.mesh.lower().split("x")[1]) if args.mesh else 0
        if model_ax < 2:
            parser.error("--seq_shard requires --mesh DATAxMODEL with MODEL >= 2 (sequence "
                         "parallelism shards activations over the model axis)")
    return args


def main(argv=None, *, tokenizer=None, video_loader=None, on_step=None) -> dict:
    """Train as the flags say; returns (and prints) the trainer's last
    logged record with the dataset's retry count beside it (``retries``:
    samples that failed to load and were replaced by a random resample).
    ``tokenizer`` replaces the checkpoint's (or the byte tokenizer),
    ``video_loader`` the dataset's ``VideoReader``; ``on_step(step, batch,
    metrics)`` is called after every step (``Trainer.train``)."""
    args = parse_args(argv)
    from livecc_tpu_torch.core.mesh import close_mesh, init_mesh
    from livecc_tpu_torch.utils.device import device_for

    device = device_for(args.device, "train.cli", " (--device cpu runs the plain versions on "
                        "the CPU)")
    mesh = None
    if args.mesh:
        mesh = init_mesh(args.mesh, args.device)
        device = mesh.device
    try:
        return _train(args, device, mesh, tokenizer, video_loader, on_step)
    finally:
        close_mesh(mesh)


def _train(args, device, mesh, tokenizer, video_loader, on_step) -> dict:
    import torch

    from livecc_tpu_torch.core.config import tiny_config
    from livecc_tpu_torch.data.lmm_dataset import LMMDataset
    from livecc_tpu_torch.data.tokenizer import ByteTokenizer, HFTokenizer
    from livecc_tpu_torch.models.qwen2_vl.convert import load_checkpoint
    from livecc_tpu_torch.models.qwen2_vl.model import init_params
    from livecc_tpu_torch.train.step import TrainConfig
    from livecc_tpu_torch.train.trainer import Trainer, TrainerConfig

    if args.pretrained:
        cfg, model = load_checkpoint(args.pretrained, device, torch.bfloat16)
        tokenizer = tokenizer or HFTokenizer(args.pretrained)
    else:
        cfg = tiny_config()
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(device)
        tokenizer = tokenizer or ByteTokenizer()

    dataset = LMMDataset(annotation_paths=args.annotation_paths, tokenizer=tokenizer, cfg=cfg,
                         with_context=args.with_context, video_loader=video_loader)
    tcfg = TrainConfig(
        learning_rate=args.learning_rate,
        warmup_ratio=args.warmup_ratio,
        total_steps=args.total_steps,
        freeze_modules=tuple(args.freeze_modules),
        ce_sup_bucket=args.ce_sup_bucket,
        adam_mu_dtype=torch.bfloat16 if args.adam_mu_dtype == "bf16" else None,
        seq_shard=args.seq_shard,
    )
    run = TrainerConfig(
        output_dir=args.output_dir,
        total_steps=args.total_steps,
        accum_steps=args.accum_steps,
        save_steps=args.save_steps,
        log_steps=args.log_steps,
        resume=not args.overwrite_output_dir,
        loader_workers=args.dataloader_num_workers,
        pack_seq=args.pack_seq,
    )
    trainer = Trainer(model, cfg, tcfg, run, dataset, mesh=mesh)
    last = {**trainer.train(on_step), "retries": dataset.retries}
    if trainer.is_main:
        print(last)
    return last


if __name__ == "__main__":
    main()

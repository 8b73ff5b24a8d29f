from livecc_tpu_torch.eval.mcq import (
    MCQItem, MCQPredictor, build_mcq_text, letter_token_ids, shard_indices)
from livecc_tpu_torch.eval import livesports3kcc, livesports3kqa, mvbench, ovobench, videomme

__all__ = [
    "MCQItem", "MCQPredictor", "build_mcq_text", "letter_token_ids", "shard_indices",
    "livesports3kcc", "livesports3kqa", "mvbench", "ovobench", "videomme",
]

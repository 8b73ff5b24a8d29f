from livecc_tpu_torch.engine.generation import (
    GenerationParams, apply_repetition_penalty, decode_chunk, prefill, select_token, update_counts,
)
from livecc_tpu_torch.engine.speculative import (
    NGramDraftSource, SpecConfig, SpecController, decode_chunk_lookahead, verify_window,
)
from livecc_tpu_torch.engine.streaming import LiveCCEngine, StreamState, TOKEN_BUCKETS

__all__ = [
    "GenerationParams", "apply_repetition_penalty", "decode_chunk", "prefill", "select_token",
    "update_counts", "NGramDraftSource", "SpecConfig", "SpecController", "decode_chunk_lookahead",
    "verify_window", "LiveCCEngine", "StreamState", "TOKEN_BUCKETS",
]

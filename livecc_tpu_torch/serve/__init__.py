"""Multi-stream serving pool (``scheduler.StreamServer``)."""

from livecc_tpu_torch.serve.scheduler import Stream, StreamServer, make_pool_step

__all__ = ["Stream", "StreamServer", "make_pool_step"]

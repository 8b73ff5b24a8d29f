"""Serving metrics (``metrics.LatencyTracker``) and FLOP counts (``flops``)."""

"""Serving metrics (``metrics.LatencyTracker``)."""

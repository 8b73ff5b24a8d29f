"""Serving metrics (``metrics.LatencyTracker``), FLOP counts (``flops``) and the
device guard of the entry points (``device.device_for``)."""

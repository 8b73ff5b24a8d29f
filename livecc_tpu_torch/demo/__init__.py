"""Demos of the port: ``python -m livecc_tpu_torch.demo.cli`` (live commentary over a video)."""

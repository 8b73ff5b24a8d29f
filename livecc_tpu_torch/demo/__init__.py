"""Demos of the port: ``python -m livecc_tpu_torch.demo.cli`` (live commentary over a
video), ``python -m livecc_tpu_torch.demo.app`` (the web demo) and ``demo.render`` (the
offline commentary-video renderer)."""

"""Runnable examples of the port (``python -m pathtracer_tpu_torch.examples.<name>``)."""

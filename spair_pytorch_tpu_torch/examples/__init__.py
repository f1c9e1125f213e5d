"""Runnable examples of the port (``python -m spair_pytorch_tpu_torch.
examples.<name>``)."""

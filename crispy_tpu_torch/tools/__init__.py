"""Command-line tools of the port (``python -m crispy_tpu_torch.tools.<name>``)."""

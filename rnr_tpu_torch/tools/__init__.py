"""The port's tools: `python -m rnr_tpu_torch.tools.<name>`."""

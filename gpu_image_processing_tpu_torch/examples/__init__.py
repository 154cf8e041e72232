"""Runnable examples of the port: `python -m
gpu_image_processing_tpu_torch.examples.<name> [--device cuda|cpu]`."""

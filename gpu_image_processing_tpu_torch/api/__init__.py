"""The `gpu_filters`-compatible API."""

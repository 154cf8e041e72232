"""Backend-neutral core: configuration, parameter validation, metrics."""

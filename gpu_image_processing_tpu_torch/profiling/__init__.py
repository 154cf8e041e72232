"""Deep profiling on torch.profiler and the modeled traffic it rates against."""

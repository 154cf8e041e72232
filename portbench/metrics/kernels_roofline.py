"""Layer: Kernels.  The least time the window's calls needed, counted by
filter function, shape and radius (`reference/work.py`: each byte read and
written once, the function's operations, at the H100 SXM's published
peaks), over the card's busy time in the traced window (kernels and
copies).  Moves `frames_per_s`."""

from portbench.reference.work import least_seconds


def read(obs: dict) -> float | None:
    trace, work = obs.get("trace"), obs.get("work")
    if not trace or not work:
        return None
    need = sum(least_seconds(f, level, shape, radius)
               for f, level, shape, radius in work)
    return 100.0 * need / trace.busy_s

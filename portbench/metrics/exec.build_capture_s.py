"""Layer: Executables.  The set-up's executable work: the host seconds of
every key's build (its untimed first run) and capture (the graph and its
untimed replay) before the window, `executables` `build_ms` plus
`capture_ms` (a program counter, kept by the cache whether spans are on
or off).  Moves `setup_s`."""


def read(obs: dict) -> float | None:
    exe = obs["before"].get("executables") or {}
    if "build_ms" not in exe or "capture_ms" not in exe:
        return None
    return (exe["build_ms"] + exe["capture_ms"]) / 1000.0

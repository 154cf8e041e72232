"""Process start to the window's start, host clock, less the seconds a
checkout's first run spends building the libraries (printed apart)."""


def read(obs: dict) -> float | None:
    return obs["setup_s"]

"""Layer: Codec.  The upload's image decode, ms a request over the
window's requests of the route: the span `codec.decode`, whichever tier
serves it, from the port's span recorder.  Moves `requests_per_s`."""

from portbench.harness.program_spans import per_request


def read(obs: dict) -> float | None:
    return per_request(obs, ("codec.decode",))

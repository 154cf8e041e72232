"""Layer: HTTP.  The server's socket work, ms a request over the window's
requests of the route: the spans `http.read` (the body off the socket)
and `http.write` (the reply's headers and body on it), from the port's
span recorder.  Moves `request_p90_ms`."""

from portbench.harness.program_spans import per_request


def read(obs: dict) -> float | None:
    return per_request(obs, ("http.read", "http.write"))

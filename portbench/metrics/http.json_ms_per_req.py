"""Layer: HTTP.  The server's JSON work, ms a request over the window's
requests of the route: the spans `http.parse` (the body's `json.loads`)
and `http.dump` (the reply's `json.dumps`), from the port's span recorder.
Moves `request_p90_ms`."""

from portbench.harness.program_spans import per_request


def read(obs: dict) -> float | None:
    return per_request(obs, ("http.parse", "http.dump"))

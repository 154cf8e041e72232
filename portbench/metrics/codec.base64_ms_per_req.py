"""Layer: Codec.  The base64 of the upload and the answers (the
passthrough original's too), ms a request over the window's requests of
the route: the spans `codec.b64decode` and `codec.b64encode`, from the
port's span recorder.  Moves `requests_per_s`."""

from portbench.harness.program_spans import per_request


def read(obs: dict) -> float | None:
    return per_request(obs, ("codec.b64decode", "codec.b64encode"))

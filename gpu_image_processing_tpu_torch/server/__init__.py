"""The REST server of the port (stdlib HTTP, no FastAPI or pydantic)."""

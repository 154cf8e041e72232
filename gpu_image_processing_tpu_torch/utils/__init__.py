"""Host-side helpers: the PNG image codec."""

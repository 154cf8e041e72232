"""Host-side helpers: the upload codec and the binding of its native decoders."""

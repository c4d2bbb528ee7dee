"""Step functions of the port: the serving half (prefill and decode)."""

"""Measurement tools of the port (run them as modules)."""

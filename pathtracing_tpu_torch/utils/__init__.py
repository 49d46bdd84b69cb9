"""Render tooling: timing and profiling, checkpoint / resume, adaptive
sampling."""

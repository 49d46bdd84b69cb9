"""Frozen copy (see rtbench/reference/snap/__init__.py)."""

"""Checkpoints in the port's own format (what serving needs)."""

"""Serving hyperparameters and observability primitives."""

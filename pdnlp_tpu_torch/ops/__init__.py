"""Attention: the plain path, the routing policy and the CUDA flash kernel."""

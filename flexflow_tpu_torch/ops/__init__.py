"""Ops of the port: graph nodes over torch tensors and the hand-written
kernels (``kernels.py``) they reach."""

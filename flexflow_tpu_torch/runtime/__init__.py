"""Runtime of the port: graph walks (``generation.py``) and the
continuous-batching serving engine (``serving.py``)."""

"""The machine model the fleet's placement advice prices transfers with
(``machine.py``; the JAX package's ``search/machine.py``). The strategy
search itself (``cost_model``, ``csim``, ``driver``) is ROADMAP item 10."""

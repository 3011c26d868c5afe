"""Static analysis (the JAX package's ``analysis``): the ffsan source
passes over the port's runtime.

  concurrency     — lock-order inversions against the declared hierarchy
                    (runtime/locks.py), locks held across blocking calls,
                    raw-lock registry bypasses.
  tracestability  — tensors made without an explicit device,
                    shape-dependent slices in the serving hot path,
                    ``torch.*`` under a lock, host reads and collections
                    inside a CUDA-graph capture.

The strategy / graph passes of the JAX package (legality, perf, schema)
check a sharding strategy against a mesh; they come with the mesh and
the search (``not_ported``, ROADMAP item 10).

Entry points:
  sanitize.analyze_sources() -> Report            (library)
  python -m flexflow_tpu_torch.analysis --passes concurrency,tracestability
"""

from __future__ import annotations

from flexflow_tpu_torch.analysis.report import Report, Violation
from flexflow_tpu_torch.analysis.sanitize import (SOURCE_PASSES,
                                                  analyze_sources)

__all__ = ["Report", "Violation", "ALL_PASSES", "SOURCE_PASSES",
           "analyze_sources"]

#: the JAX package's strategy / graph passes, not ported
ALL_PASSES = ("legality", "perf", "schema")

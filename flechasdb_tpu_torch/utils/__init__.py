"""Host-side utilities with reference-parity semantics (the port carries
the JAX package's ``distribution``, ``nbest`` and ``profiling``)."""

from .distribution import WeightedIndex
from .nbest import NBestByKey, n_best_by_key
from .profiling import annotate, trace

__all__ = ["NBestByKey", "WeightedIndex", "annotate",
           "n_best_by_key", "trace"]

"""Host-side utilities with reference-parity semantics (the port carries
the JAX package's ``distribution``, ``nbest`` and ``profiling``)."""

from .distribution import WeightedIndex
from .nbest import NBestByKey, n_best_by_key
from .profiling import (annotate, annotated, count, counters,
                        reset_counters, trace)

__all__ = ["NBestByKey", "WeightedIndex", "annotate", "annotated",
           "count", "counters", "n_best_by_key", "reset_counters", "trace"]

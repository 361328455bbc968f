"""Host-side utilities with reference-parity semantics (the port carries
the JAX package's ``nbest``)."""

from .nbest import NBestByKey, n_best_by_key

__all__ = ["NBestByKey", "n_best_by_key"]

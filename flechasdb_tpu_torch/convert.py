"""Databases carried between the JAX package and the port in memory.

Both hold the same host fields (numpy arrays, UUIDs, the attribute
table); nothing here imports jax. :func:`to_arrays` gives the keyword
arguments of ``flechasdb_tpu.build.Database``, and :func:`from_jax_arrays`
takes them back. Persisting needs neither: the port saves and loads the
same trees itself (:mod:`.serialize`, :mod:`.stored`).
"""

from __future__ import annotations

import numpy as np
import torch

from .build import Database

FIELDS = ("vector_size", "num_partitions", "num_divisions", "num_clusters",
          "vector_ids", "partition_centroids", "partition_indices",
          "codebooks", "codes", "residues", "rotation", "metric",
          "attribute_table")


def from_jax_arrays(db, device: str | torch.device = "cuda") -> Database:
    """The port's :class:`Database` on the fields of a JAX package's
    ``Database`` (or any object that has them), the OPQ rotation
    included."""
    fields = {name: getattr(db, name) for name in FIELDS}
    if fields["rotation"] is not None:
        fields["rotation"] = np.asarray(fields["rotation"], np.float32)
    fields["vector_ids"] = list(fields["vector_ids"])
    fields["codes"] = np.asarray(fields["codes"], np.uint32)
    fields["partition_indices"] = np.asarray(fields["partition_indices"],
                                             np.int32)
    return Database(**fields, device=str(torch.device(device)))


def to_arrays(db: Database) -> dict:
    """The host fields of ``db``, keyed as ``flechasdb_tpu.build.Database``
    takes them."""
    fields = {name: getattr(db, name) for name in FIELDS}
    fields["vector_ids"] = list(fields["vector_ids"])
    return fields

"""Scale-out over ranks (the JAX package's ``parallel`` package), on
``torch.distributed``: one process a rank, every sharded entry point a
collective call (:mod:`.mesh`).

* :mod:`.mesh`: the corpus mesh, row blocks and the collective helpers;
* :mod:`.kmeans`: each rank's Lloyd kernels on its rows, the sums added
  in rank order;
* :mod:`.build`: the single-device build (``build_staged``) and the
  sharded one (``build_sharded``);
* :mod:`.query`, :mod:`.bucketed`, :mod:`.exact`: sharded serving on the
  masked and bucketed layouts and the flat tier.

Not carried over: ``build_step_donating`` (XLA buffer donation).
"""

from .build import (COARSE_TRAIN_CAP, PQ_TRAIN_CAP, ShardedBuild,
                    build_sharded, build_staged)
from .exact import exact_keys_sharded, exact_sharded, rerank_sharded, \
    shard_flat
from .kmeans import fit_sharded
from .mesh import CorpusMesh, corpus_mesh, shard_corpus
from .query import query_sharded, range_sharded

__all__ = [
    "COARSE_TRAIN_CAP",
    "PQ_TRAIN_CAP",
    "CorpusMesh",
    "ShardedBuild",
    "build_sharded",
    "build_staged",
    "corpus_mesh",
    "exact_keys_sharded",
    "exact_sharded",
    "fit_sharded",
    "query_sharded",
    "range_sharded",
    "rerank_sharded",
    "shard_corpus",
    "shard_flat",
]

"""The JAX package's ``parallel`` package, its single-device build
(:mod:`.build`). The sharded build, the mesh and sharded serving are
ROADMAP item 20."""

from .build import (COARSE_TRAIN_CAP, PQ_TRAIN_CAP, ShardedBuild,
                    build_staged)

__all__ = ["COARSE_TRAIN_CAP", "PQ_TRAIN_CAP", "ShardedBuild",
           "build_staged"]

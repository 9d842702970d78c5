"""Parallel execution on ``torch.distributed``: the rank mesh, spec
trees, fold sharding, data-parallel steps, and the launcher that starts
the ranks (``parallel/launch.py``; see ``parallel/mesh.py`` for the
design on one card)."""

from eegnetreplication_tpu_torch.parallel.dp import (  # noqa: F401
    make_dp_eval_step,
    make_dp_train_step,
)
from eegnetreplication_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    FOLD_AXIS,
    MODEL_AXIS,
    initialize_distributed,
    make_hybrid_mesh,
    make_mesh,
    mesh_size,
)
from eegnetreplication_tpu_torch.parallel.shardspec import (  # noqa: F401
    StateShardSpec,
    fold_stacked_spec_tree,
    place_fold_stacked,
    shard_state,
    state_shard_spec,
)

"""Training subpackage of the torch port: checkpoints and run snapshots,
the snapshot writer, steps, the fold loop, both protocols and their
reports (the same exports as the JAX package's ``training``)."""

from eegnetreplication_tpu_torch.training.loop import (  # noqa: F401
    FoldResult,
    FoldSpec,
    FoldTrainer,
    evaluate_pool,
    init_fold_states,
    make_fold_spec,
)
from eegnetreplication_tpu_torch.training.steps import (  # noqa: F401
    TrainState,
    eval_step,
    train_step,
)

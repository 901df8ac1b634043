"""Training of FlowFormerCov (port of ``macvo_tpu/train``): losses, the
freeze policy, the optimizer and its schedule, the step and the runner
``python -m macvo_tpu_torch.train.run``."""

from .loss import GlobalBatch, cov_loss, final_cov_loss, flow_loss, sequence_loss, sequence_metrics
from .step import (
    COV_BRANCH_MARKERS,
    Optimizer,
    TrainConfig,
    apply_freeze,
    create_optimizer,
    is_cov_param,
    make_schedule,
    make_sharded_train_step,
    make_train_step,
)

__all__ = [
    "COV_BRANCH_MARKERS", "GlobalBatch", "Optimizer", "TrainConfig", "apply_freeze", "cov_loss",
    "create_optimizer", "final_cov_loss", "flow_loss", "is_cov_param", "make_schedule",
    "make_sharded_train_step", "make_train_step", "sequence_loss", "sequence_metrics",
]

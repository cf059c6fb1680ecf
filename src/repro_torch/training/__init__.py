"""Training: AdamW, the train step (with per-layer remat and
microbatching), the synthetic data pipeline and npz checkpoints — the
port of ``src/repro/training``."""
from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.training.data import SyntheticCorpus, packed_batches
from repro_torch.training.optimizer import (
    OptimizerConfig,
    OptState,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_schedule,
)
from repro_torch.training.train import (build_train_step, init_train_state,
                                        value_and_grad)

__all__ = [
    "OptimizerConfig", "OptState", "adamw_update", "global_norm",
    "init_opt_state", "lr_schedule", "build_train_step", "init_train_state",
    "value_and_grad",
    "SyntheticCorpus", "packed_batches",
    "save_checkpoint", "restore_checkpoint",
]

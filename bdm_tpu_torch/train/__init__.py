"""Training: optimizer and schedule factories, EMA, the train step, the
loop and checkpoints (`bdm_tpu/train/`, reference
`experiments/training_utils.py` and the `main*.py` loops).

AdamW with no-decay groups (`training_utils.py:42-53`), linear / cosine
warm-up schedules (`config/structured.py:236-263`), gradient clip 50
(`structured.py:209`), EMA 0.999 every 20 steps (`structured.py:194-198`),
the NaN-loss hard stop (`main.py:231-234`) and checkpoint / resume with
`torch.save` under the reference `state_dict` keys. Data parallel over a
process group: `make_train_step(loss_fn, group)` and `train_loop(...,
group=...)` (`bdm_tpu_torch.parallel`).
"""

from bdm_tpu_torch.train.checkpoint import (load_params, restore_checkpoint,
                                            save_checkpoint, save_params)
from bdm_tpu_torch.train.loop import NaNLossError, train_loop
from bdm_tpu_torch.train.metrics import MetricLogger, SmoothedValue
from bdm_tpu_torch.train.optimizers import (Optimizer, fusion_freeze_mask,
                                            make_lr_schedule, make_optimizer,
                                            pc2_freeze_mask)
from bdm_tpu_torch.train.state import TrainState, create_train_state
from bdm_tpu_torch.train.step import make_train_step

__all__ = [
    "MetricLogger", "NaNLossError", "Optimizer", "SmoothedValue",
    "TrainState", "create_train_state", "fusion_freeze_mask", "load_params",
    "make_lr_schedule", "make_optimizer", "make_train_step",
    "pc2_freeze_mask", "restore_checkpoint", "save_checkpoint",
    "save_params", "train_loop",
]

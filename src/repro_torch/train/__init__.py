# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""repro_torch.train — optimizer, train-step factory, fault-tolerant loop
(port of ``repro.train``)."""
from .optim import AdamWConfig, OptState, adamw_update, init_opt_state
from .step import TrainStepConfig, make_train_step

__all__ = ["AdamWConfig", "OptState", "adamw_update", "init_opt_state",
           "TrainStepConfig", "make_train_step"]

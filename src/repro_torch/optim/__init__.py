from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          global_norm_clip, sgd)
from repro_torch.optim.schedule import constant, cosine_schedule, linear_warmup

__all__ = ["Optimizer", "adamw", "sgd", "apply_updates", "global_norm_clip",
           "cosine_schedule", "linear_warmup", "constant"]

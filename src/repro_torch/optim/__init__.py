from repro_torch.optim.optimizers import Optimizer, adamw, apply_updates

__all__ = ["Optimizer", "adamw", "apply_updates"]

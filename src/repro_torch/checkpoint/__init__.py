from repro_torch.checkpoint.msgpack_ckpt import (latest_step, read_leaves,
                                                 restore_checkpoint,
                                                 save_checkpoint,
                                                 tree_flatten,
                                                 tree_unflatten)

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint",
           "read_leaves", "tree_flatten", "tree_unflatten"]

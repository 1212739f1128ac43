from repro_torch.models.common import P, build, tree_leaves, tree_map

__all__ = ["P", "build", "tree_leaves", "tree_map"]

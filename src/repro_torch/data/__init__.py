"""Numpy data plumbing for the port (copies of the reference's
``data/mixtures.py`` and ``data/federated.py``; no framework imports)."""

from repro_torch.data.federated import (FederatedDataset, dirichlet_partition,
                                        federated_split,
                                        quantity_skew_partition)
from repro_torch.data.mixtures import (GaussianMixture, digits_like_mixture,
                                       make_user_domains, template_coverage)

__all__ = [
    "GaussianMixture", "make_user_domains", "digits_like_mixture",
    "template_coverage", "federated_split", "dirichlet_partition",
    "quantity_skew_partition", "FederatedDataset",
]

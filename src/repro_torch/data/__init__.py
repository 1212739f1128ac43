"""Data plumbing for the port: copies of the reference's
``data/mixtures.py`` and ``data/federated.py`` (numpy) and
``data/synthetic.py`` (its token batches drawn through ``prng``)."""

from repro_torch.data.federated import (FederatedDataset, dirichlet_partition,
                                        federated_split,
                                        quantity_skew_partition)
from repro_torch.data.mixtures import (GaussianMixture, digits_like_mixture,
                                       make_user_domains, template_coverage)
from repro_torch.data.synthetic import (TokenStream, synthetic_batch_for,
                                        synthetic_lm_batch)

__all__ = [
    "TokenStream", "synthetic_lm_batch", "synthetic_batch_for",
    "GaussianMixture", "make_user_domains", "digits_like_mixture",
    "template_coverage", "federated_split", "dirichlet_partition",
    "quantity_skew_partition", "FederatedDataset",
]

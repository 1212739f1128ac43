"""Multi-tenant generation serving over a FederationSession (port of the
reference's ``serve/``): bucketed sampler engine, micro-batching scheduler,
continuous-batching decode engine, hot-swappable service."""

from repro_torch.serve.decode import DecodeEngine, DecodeRequest
from repro_torch.serve.sampler import SamplerEngine
from repro_torch.serve.scheduler import MicroBatcher, SampleRequest, flush_due
from repro_torch.serve.service import GenerationService, RateLimitExceeded

__all__ = ["SamplerEngine", "MicroBatcher", "SampleRequest", "flush_due",
           "DecodeEngine", "DecodeRequest", "GenerationService",
           "RateLimitExceeded"]

"""Shared fixtures.  NOTE: no XLA_FLAGS here on purpose — smoke tests and
benches must see the single real CPU device; multi-device tests spawn
subprocesses that set --xla_force_host_platform_device_count themselves."""

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc (skips without them)")


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.key(0)


ARCHS = [
    "mamba2-780m",
    "seamless-m4t-medium",
    "recurrentgemma-9b",
    "deepseek-moe-16b",
    "stablelm-1.6b",
    "tinyllama-1.1b",
    "yi-34b",
    "qwen2-72b",
    "chameleon-34b",
    "deepseek-v2-lite-16b",
]

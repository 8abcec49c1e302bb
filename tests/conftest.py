"""Test configuration: run JAX on a virtual 8-device CPU mesh so sharding
tests work without accelerators, per the multi-device validation strategy.

An explicit JAX_PLATFORMS wins: `JAX_PLATFORMS=cuda,cpu pytest -m gpu
tests/` runs the tests that need an NVIDIA GPU on the card (the `gpu`
fixture skips them everywhere else)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import json
import pathlib

import numpy as np
import pytest

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"

_DTYPES = {"int32": np.int32, "float64": np.float64,
           "complex128": np.complex128, "float32": np.float32,
           "uint8": np.uint8}


class GoldenStore:
    def __init__(self):
        self.meta = {}
        for meta_file in sorted(GOLDEN.glob("meta*.json")):
            with open(meta_file) as f:
                self.meta.update(json.load(f))

    def __call__(self, name: str) -> np.ndarray:
        info = self.meta[name]
        arr = np.fromfile(GOLDEN / f"{name}.bin", dtype=_DTYPES[info["dtype"]])
        return arr.reshape(info["shape"])

    def __contains__(self, name: str) -> bool:
        return name in self.meta


@pytest.fixture(scope="session")
def golden():
    return GoldenStore()


@pytest.fixture(scope="module", autouse=True)
def _xla_cpu_compile_state_guard():
    """The XLA CPU compiler segfaults nondeterministically when compiling
    large programs on top of a few hundred accumulated executables
    (first seen on the 8-way SPMD lowerings in test_scale, then in plain
    full-suite runs as the suite grew). Clearing the compile cache at
    every module boundary bounds the accumulated state; per-module
    recompiles cost seconds against a suite that must not crash."""
    jax.clear_caches()
    yield


@pytest.fixture
def gpu():
    """The first JAX device when it is an NVIDIA GPU; skips the test on any
    other backend. Decided here, at run time, never at import."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX found {dev.platform}); run "
                    "`JAX_PLATFORMS=cuda,cpu pytest -m gpu tests/` on a card")
    return dev

"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests run on the CPU (``JAX_PLATFORMS=cpu``); sharding is validated on
virtual CPU devices.  The GPU run is ``python chip_smoke.py`` (see README).
"""

import os
import sys
from pathlib import Path

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


# the upstream pyReCoDe checkout the interop tests compare against; only the
# one PYRECODE_REFERENCE names, never a path guessed around this checkout
_REFERENCE_ENV = os.environ.get("PYRECODE_REFERENCE")
REFERENCE_TREE = Path(_REFERENCE_ENV) if _REFERENCE_ENV else None


def require_reference_tree() -> Path:
    """The reference tree; skips the calling test when it is unset or absent."""
    if REFERENCE_TREE is None:
        pytest.skip("PYRECODE_REFERENCE is not set")
    if not (REFERENCE_TREE / "pyrecode").is_dir():
        pytest.skip(f"reference tree {REFERENCE_TREE} unavailable")
    return REFERENCE_TREE


@pytest.fixture
def reference_tree():
    """The reference tree on ``sys.path``; the test skips when it is absent."""
    require_reference_tree()
    if str(REFERENCE_TREE) not in sys.path:
        sys.path.insert(0, str(REFERENCE_TREE))
    return REFERENCE_TREE

"""Test environment: CPU JAX with 8 virtual devices, so the sharding tests
run on any machine.  GPU runs go through chip_smoke.py."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest


@pytest.fixture(scope="session")
def wdas_vdb():
    """Path of the WDAS sixteenth-cloud VDB.  The file is not part of the
    repository: tests that need it skip unless it is placed at
    SceneConfig.volume_path under the repository root."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data/volume/wdas_cloud_sixteenth.vdb")
    if not os.path.exists(path):
        pytest.skip(f"WDAS cloud VDB not found at {path}")
    return path


@pytest.fixture(scope="session")
def cloud_grid(wdas_vdb):
    """Dense WDAS sixteenth-cloud density grid (cached per session)."""
    from nrc_hpm.utils.vdb import load_vdb
    # pure-Python parser: tests also assert on grid metadata, which the
    # native fast path does not surface
    return load_vdb(wdas_vdb, prefer_native=False)


@pytest.fixture(scope="session")
def seeded_grid():
    """The seeded stand-in cloud at the WDAS sixteenth grid's dims."""
    from nrc_hpm.volume import seeded_cloud
    return seeded_cloud(0)


@pytest.fixture(scope="session")
def small_volume():
    """An 8^3 heterogeneous test volume."""
    from nrc_hpm.volume import Volume
    rs = np.random.RandomState(42)
    data = rs.rand(8, 8, 8).astype(np.float32)
    return Volume.from_dense(data, density_factor=0.6, g=0.8)


@pytest.fixture(scope="session")
def cube_volume():
    from nrc_hpm.volume import Volume
    return Volume.homogeneous_cube(4, 1.0, density_factor=0.5, g=0.0)

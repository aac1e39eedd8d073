import jax
import pytest

from repro.compat import make_mesh


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips elsewhere (tests/test_torch_gpu.py)"
    )


@pytest.fixture(scope="session")
def host_mesh():
    # 1×1 mesh: smoke tests see the single CPU device (the 512-device
    # override belongs ONLY to the dry-run, per its module header).
    return make_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="session")
def dist_mesh_shape():
    """(rows, cols) for the distributed-engine tests: the largest 2D grid
    the available devices support. Single-device runs degrade to 1×1; the
    CI multidevice job forces 8 host devices so the shard_map collectives
    actually execute across a 2×4 grid."""
    n = jax.device_count()
    if n >= 8:
        return (2, 4)
    if n >= 4:
        return (2, 2)
    if n >= 2:
        return (1, 2)
    return (1, 1)


@pytest.fixture(scope="session")
def dist_mesh(dist_mesh_shape):
    return make_mesh(dist_mesh_shape, ("data", "model"))

"""Test harness configuration.

Tests run JAX on a virtual 8-device CPU mesh (no GPU needed). PCR_FORCE_JAX
makes the pipeline treat the JAX CPU backend as an accelerator so the
device code path is exercised by the parity tests.

A run that selects the card-marked tests (`python -m pytest -m gpu tests/`,
on a machine with an NVIDIA GPU) leaves the platform to JAX; the `gpu_device`
fixture skips those tests where no GPU is present.
"""

import os
import sys


def selects_gpu_tests(argv) -> bool:
    """True when the pytest arguments select the card-marked tests
    (`-m gpu`, `-m "gpu and ..."`), judged from the arguments alone."""
    for i, a in enumerate(argv):
        expr = (argv[i + 1] if a == "-m" and i + 1 < len(argv)
                else a[2:] if a.startswith("-m") and len(a) > 2 else None)
        if expr and "gpu" in expr.split() and "not gpu" not in expr:
            return True
    return False


GPU_RUN = selects_gpu_tests(sys.argv[1:])
if not GPU_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8")
    os.environ.setdefault("PCR_FORCE_JAX", "1")

import jax  # noqa: E402

if not GPU_RUN:
    jax.config.update("jax_platforms", "cpu")

import warnings

import numpy as np
import pytest

import pcr_tpu as pcr

warnings.filterwarnings("ignore", message=".*donat.*")


@pytest.fixture
def gpu_device():
    """The first NVIDIA GPU JAX sees; skips the test where there is none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest -m gpu "
                    "tests/` on a machine with one")
    return devs[0]


@pytest.fixture
def grid_config():
    """1000x1000 grid @ cell 1.0, tile 256, EPSG:3857 — mirrors the
    reference fixture (tests/cpp/test_helpers.h:27-97)."""
    bbox = pcr.BBox()
    bbox.min_x, bbox.min_y, bbox.max_x, bbox.max_y = 0.0, 0.0, 1000.0, 1000.0
    gc = pcr.GridConfig()
    gc.bounds = bbox
    gc.cell_size_x = 1.0
    gc.cell_size_y = -1.0
    gc.tile_width = 256
    gc.tile_height = 256
    gc.crs = pcr.CRS.from_epsg(3857)
    gc.compute_dimensions()
    return gc


def make_grid_config(w=100.0, h=100.0, cell=1.0, tile=4096, epsg=3857):
    bbox = pcr.BBox()
    bbox.min_x, bbox.min_y, bbox.max_x, bbox.max_y = 0.0, 0.0, w, h
    gc = pcr.GridConfig()
    gc.bounds = bbox
    gc.cell_size_x = cell
    gc.cell_size_y = -cell
    gc.tile_width = tile
    gc.tile_height = tile
    gc.crs = pcr.CRS.from_epsg(epsg)
    gc.compute_dimensions()
    return gc


def make_cloud(n, seed=0, w=100.0, h=100.0, channels=("v",)):
    rng = np.random.default_rng(seed)
    c = pcr.PointCloud.create(n)
    c.set_x_array(rng.uniform(0, w, n))
    c.set_y_array(rng.uniform(0, h, n))
    for name in channels:
        c.add_channel(name, pcr.DataType.Float32)
        c.set_channel_array_f32(name, rng.normal(0, 1, n).astype(np.float32))
    return c


@pytest.fixture
def tmp_state_dir(tmp_path):
    return str(tmp_path / "state")

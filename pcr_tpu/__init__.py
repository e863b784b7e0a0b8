"""
PCR-TPU — Point Cloud Rasterization on JAX.

A from-scratch JAX/XLA framework with the capabilities of the
reference CUDA/C++ `pcr` library (BigHippo123/pointcloud-raster):
reduce large 2-D point clouds onto regular geo-referenced raster grids.
Each point scatters a value into one cell (Point glyph) or paints a
weighted multi-cell footprint (Line / Gaussian glyph), folded per cell
by a pluggable reduction op (Sum / Average / WeightedAverage / Max /
Min / Count).  Large grids are tiled out-of-core with an LRU tile-state
cache spilling to disk, and final rasters are written as GeoTIFF.

Design (the reference's CUDA atomic scatter, expressed in XLA):
  * points scatter-add into device state (`state.at[cells].add`), which
    the GPU runs as atomics; Gaussian footprints take either the
    reference's window loop or a *separable* soft one-hot product, Lines
    expand via vectorized Bresenham.
  * Max/Min go through scatter-max/min, MostRecent through a three-scatter
    lexicographic argmax.
  * Results match the numpy CPU oracle to float tolerance; device float
    sums are atomics, so reruns on the GPU can differ in the last bits.

The public API mirrors the reference Python bindings
(reference: python/bindings.cpp:31-575, python/pcr/__init__.py:17-237)
so reference users can switch by replacing `import pcr` with
`import pcr_tpu as pcr` (or just `import pcr`, which this repo aliases).
"""

__version__ = "0.3.0"

import os as _os

_version_file = _os.path.join(_os.path.dirname(__file__), "..", "VERSION")
if _os.path.exists(_version_file):
    with open(_version_file) as _f:
        __version__ = _f.read().strip()

from .core.types import (
    DataType,
    ReductionType,
    MemoryLocation,
    StatusCode,
    Status,
    PcrError,
    BBox,
    CRS,
    NoDataPolicy,
    TileIndex,
    data_type_size,
    tpu_is_compiled,
    tpu_device_available,
    tpu_device_count,
    tpu_device_name,
    tpu_memory_info,
)
from .core.grid_config import GridConfig
from .core.grid import Grid, BandDesc
from .core.point_cloud import PointCloud, ChannelDesc
from .ops.reduction import (
    ReductionOp,
    ReductionInfo,
    get_reduction_info,
    registered_reductions,
    register_custom_reduction,
    unregister_reduction,
)
from .engine.filter import CompareOp, FilterPredicate, FilterSpec
from .engine.glyph import GlyphType, GlyphSpec
from .engine.pipeline import (
    ExecutionMode,
    ReductionSpec,
    PipelineConfig,
    ProgressInfo,
    Pipeline,
)
from .io.geotiff import (
    GeoTiffOptions,
    write_geotiff,
    read_geotiff_info,
    read_geotiff_band,
    TiledGeoTiffWriter,
)
from .io.point_cloud_io import (
    PointCloudFormat,
    PointCloudInfo,
    read_point_cloud,
    write_point_cloud,
    read_point_cloud_info,
    PointCloudReader,
)


# ---------------------------------------------------------------------------
# Convenience helpers for glyph ReductionSpec construction
# (reference: python/pcr/__init__.py:73-181)
# ---------------------------------------------------------------------------

def gaussian_splat_spec(
    value_channel,
    sigma_x_channel="",
    sigma_y_channel="",
    rotation_channel="",
    default_sigma=1.0,
    default_sigma_x=None,
    default_sigma_y=None,
    default_rotation=0.0,
    max_radius_cells=32.0,
    output_band_name=None,
):
    """Build a ``ReductionSpec`` that rasterizes each point as an
    anisotropic Gaussian blob (WeightedAverage reduction).

    Instead of landing on a single cell, every point contributes
    ``w = exp(-(dx²/2σx² + dy²/2σy²))`` to all cells within its truncated
    elliptical footprint — useful for turning sparse clouds into smooth
    continuous surfaces.  On the device backend axis-aligned blobs whose
    window stays inside the weight cutoff take the separable splat (one
    matrix product per block of points); rotated and small-sigma blobs
    take the exact window splat.

    Arguments mirror the fields they populate on ``spec.glyph``:

    - ``value_channel``: which point channel supplies the splatted value.
    - ``sigma_x_channel`` / ``sigma_y_channel`` / ``rotation_channel``:
      names of per-point channels overriding the ellipse shape.  An empty
      string means "use the scalar default below for every point".
    - ``default_sigma``: isotropic fallback σ (world units); the
      per-axis ``default_sigma_x`` / ``default_sigma_y`` win when given.
    - ``default_rotation``: fallback ellipse angle, radians CCW.
    - ``max_radius_cells``: hard cap on the footprint half-width, in
      cells, so one wild σ cannot splat the whole grid.
    - ``output_band_name``: optional label for the resulting band.

    Equivalent of the reference helper (python/pcr/__init__.py:73-131);
    semantics of the kernel match glyph_kernels.cu:98-143.
    """
    spec = ReductionSpec()
    spec.value_channel = value_channel
    spec.type = ReductionType.WeightedAverage
    spec.glyph.type = GlyphType.Gaussian
    spec.glyph.sigma_x_channel = sigma_x_channel
    spec.glyph.sigma_y_channel = sigma_y_channel
    spec.glyph.rotation_channel = rotation_channel
    spec.glyph.default_sigma_x = (
        default_sigma_x if default_sigma_x is not None else default_sigma
    )
    spec.glyph.default_sigma_y = (
        default_sigma_y if default_sigma_y is not None else default_sigma
    )
    spec.glyph.default_rotation = default_rotation
    spec.glyph.max_radius_cells = max_radius_cells
    if output_band_name:
        spec.output_band_name = output_band_name
    return spec


def line_splat_spec(
    value_channel,
    direction_channel="",
    half_length_channel="",
    default_direction=0.0,
    default_half_length=1.0,
    max_radius_cells=32.0,
    output_band_name=None,
):
    """Build a ``ReductionSpec`` that rasterizes each point as a thin
    line segment (WeightedAverage reduction).

    The segment is centered on the point, runs along ``direction``
    (radians, 0 = +X/East), and spans ``half_length`` world units to
    either side; cells are selected by Bresenham traversal so the stroke
    stays one cell wide at any angle.  The device backend walks every
    segment in lockstep and commits all covered cells with one
    scatter-add.

    - ``value_channel``: point channel whose value the stroke deposits.
    - ``direction_channel`` / ``half_length_channel``: per-point
      overrides; empty string selects the scalar defaults.
    - ``default_direction`` / ``default_half_length``: used when no
      per-point channel is named.
    - ``max_radius_cells``: clamp on the stroke's reach in cells.
    - ``output_band_name``: optional label for the resulting band.

    Equivalent of the reference helper (python/pcr/__init__.py:134-181);
    stroke semantics match glyph_kernels.cu:145-176.
    """
    spec = ReductionSpec()
    spec.value_channel = value_channel
    spec.type = ReductionType.WeightedAverage
    spec.glyph.type = GlyphType.Line
    spec.glyph.direction_channel = direction_channel
    spec.glyph.half_length_channel = half_length_channel
    spec.glyph.default_direction = default_direction
    spec.glyph.default_half_length = default_half_length
    spec.glyph.max_radius_cells = max_radius_cells
    if output_band_name:
        spec.output_band_name = output_band_name
    return spec


__all__ = [
    # Enums
    "DataType", "ReductionType", "MemoryLocation", "ExecutionMode",
    "StatusCode", "CompareOp", "PointCloudFormat", "GlyphType",
    # Core types
    "BBox", "CRS", "NoDataPolicy", "TileIndex", "Status", "PcrError",
    "ChannelDesc", "BandDesc",
    # Grid
    "GridConfig", "Grid",
    # PointCloud
    "PointCloud",
    # Filter
    "FilterPredicate", "FilterSpec",
    # Pipeline / Glyph
    "GlyphSpec", "ReductionSpec", "PipelineConfig", "ProgressInfo", "Pipeline",
    # Glyph helpers
    "gaussian_splat_spec", "line_splat_spec",
    # Ops
    "ReductionOp", "ReductionInfo", "get_reduction_info", "registered_reductions",
    "register_custom_reduction", "unregister_reduction",
    # I/O — GeoTIFF
    "GeoTiffOptions", "write_geotiff", "read_geotiff_info", "read_geotiff_band",
    "TiledGeoTiffWriter",
    # I/O — Point cloud
    "PointCloudInfo", "read_point_cloud", "write_point_cloud",
    "read_point_cloud_info", "PointCloudReader",
    # Device probes
    "data_type_size", "tpu_is_compiled", "tpu_device_available",
    "tpu_device_count", "tpu_device_name", "tpu_memory_info",
]

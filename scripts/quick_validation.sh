#!/bin/bash
# Quick validation for pcr-tpu: is the install healthy on this machine?
#
# The analogue of the reference's quick_validation.sh
# (scripts/shell/quick_validation.sh in BigHippo123/pointcloud-raster):
# where the reference probes per-suite GTest executables and CUDA, we
# probe the pytest areas, the GPU, the fallback ladder, and the
# README quickstart.  Exit code 0 = everything checked out.
set -u
REPO="$(cd "$(dirname "$0")/.." && pwd)"
cd "$REPO"

GREEN='\033[0;32m'; YELLOW='\033[1;33m'; BLUE='\033[0;34m'; NC='\033[0m'
FAIL=0

banner() { echo "==========================================="; }
banner; echo "pcr-tpu quick validation"; banner; echo ""

# --- 1. device probe -------------------------------------------------
echo -e "${BLUE}1. Accelerator probe${NC}"
python - <<'PY'
import pcr_tpu as pcr
print(f"  tpu_is_compiled   : {pcr.tpu_is_compiled()}")
print(f"  tpu_device_available: {pcr.tpu_device_available()}")
if pcr.tpu_device_available():
    print(f"  device            : {pcr.tpu_device_name(0)}")
    mem = pcr.tpu_memory_info()
    if mem:  # None on platforms that do not expose memory stats
        print(f"  memory            : {mem[0]/2**30:.1f} / {mem[1]/2**30:.1f} GiB free")
PY
[ $? -ne 0 ] && FAIL=1
echo ""

# --- 2. test areas ----------------------------------------------------
# Mirrors the reference's per-suite breakdown (gpu / threading /
# error-handling / pipeline) with our pytest files.
run_area() {
    local label="$1"; shift
    local out
    out=$(python -m pytest -q "$@" 2>&1 | tail -1)
    if echo "$out" | grep -Eq "^[0-9]+ passed"; then
        echo -e "  ${GREEN}OK${NC} $label: $out"
    else
        echo -e "  ${YELLOW}!!${NC} $label: $out"
        FAIL=1
    fi
}
echo -e "${BLUE}2. Test areas${NC}"
run_area "core types     " tests/test_types.py tests/test_grid_config.py \
    tests/test_grid.py tests/test_point_cloud.py
run_area "reduction ops  " tests/test_reduction_ops.py
run_area "engine         " tests/test_native.py tests/test_accumulator.py \
    tests/test_filter.py tests/test_tile_manager.py
run_area "device backend " tests/test_device_cloud.py tests/test_parity.py
run_area "error handling " tests/test_error_handling.py
run_area "pipeline       " tests/test_pipeline.py
run_area "sharded (8-dev)" tests/test_sharding.py
echo ""

# --- 3. quickstart end-to-end ----------------------------------------
echo -e "${BLUE}3. README quickstart (end-to-end)${NC}"
if timeout 600 python examples/quickstart.py >/tmp/pcr_quickstart.log 2>&1; then
    echo -e "  ${GREEN}OK${NC} $(grep -Eo 'wrote .*|[0-9.]+ Mpts/s.*' /tmp/pcr_quickstart.log | head -1)"
else
    echo -e "  ${YELLOW}!!${NC} quickstart failed; see /tmp/pcr_quickstart.log"
    FAIL=1
fi
echo ""

# --- 4. fallback ladder ----------------------------------------------
echo -e "${BLUE}4. Fallback ladder${NC}"
python - <<'PY'
import numpy as np, pcr_tpu as pcr
gc = pcr.GridConfig(); gc.bounds = pcr.BBox()
gc.bounds.min_x = gc.bounds.min_y = 0.0
gc.bounds.max_x = gc.bounds.max_y = 64.0
gc.cell_size_x, gc.cell_size_y = 1.0, -1.0
gc.crs = pcr.CRS.from_epsg(3857)
gc.compute_dimensions()
cloud = pcr.PointCloud.create(1000)
rng = np.random.default_rng(0)
cloud.set_x_array(rng.uniform(0, 64, 1000))
cloud.set_y_array(rng.uniform(0, 64, 1000))
cloud.add_channel("v", pcr.DataType.Float32)
cloud.set_channel_array_f32("v", np.ones(1000, np.float32))
for mode in ("CPU", "Auto"):
    cfg = pcr.PipelineConfig(); cfg.grid = gc
    spec = pcr.ReductionSpec(); spec.type = pcr.ReductionType.Sum
    spec.value_channel = "v"; cfg.reductions = [spec]
    cfg.exec_mode = getattr(pcr.ExecutionMode, mode)
    p = pcr.Pipeline.create(cfg); p.ingest(cloud); p.finalize()
    total = np.nansum(p.result().band_array(0))
    assert abs(total - 1000.0) < 1e-3, (mode, total)
    print(f"  mode={mode:6s} sum={total:.0f}  backend ok")
print("  Auto mode falls back GPU->CPU transparently (see docs/ERROR_HANDLING.md)")
PY
[ $? -ne 0 ] && FAIL=1
echo ""

banner
if [ "$FAIL" -eq 0 ]; then
    echo -e "${GREEN}pcr-tpu validated successfully${NC}"
else
    echo -e "${YELLOW}validation finished with failures${NC}"
fi
banner
exit $FAIL

"""GeoTIFF I/O tests (reference: tests/cpp/test_grid_io.cpp:34-465)."""

import numpy as np
import pytest

import pcr_tpu as pcr
from pcr_tpu.io.geotiff import (
    GeoTiffOptions, TiledGeoTiffWriter, lzw_decode, lzw_encode,
    read_geotiff_band, read_geotiff_info, write_geotiff,
)
from conftest import make_grid_config


def make_grid(names, w=64, h=48, seed=0):
    rng = np.random.default_rng(seed)
    g = pcr.Grid.create(w, h, [pcr.BandDesc(name=n) for n in names])
    arrays = []
    for i in range(len(names)):
        a = rng.random((h, w)).astype(np.float32)
        g.set_band_array(i, a)
        arrays.append(a)
    return g, arrays


class TestLzw:
    @pytest.mark.parametrize("size", [0, 1, 255, 4096, 100_000])
    def test_roundtrip_random(self, size):
        data = np.random.default_rng(size or 1).integers(
            0, 256, size, dtype=np.uint8).tobytes()
        assert lzw_decode(lzw_encode(data)) == data

    def test_roundtrip_runs(self):
        data = b"abc" * 10000 + b"\x00" * 5000
        enc = lzw_encode(data)
        assert lzw_decode(enc) == data
        assert len(enc) < len(data) // 2   # compresses repetitive data


class TestExternalInterop:
    """Read fixtures written by Pillow/libtiff — NOT this library's
    writer (reference reads any GDAL flavor, grid_io.cpp:372-497).
    Regenerate with tests/data/make_external_fixtures.py
    (deterministic, seed 0)."""

    @staticmethod
    def _fixtures():
        import os
        here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data")
        import sys
        sys.path.insert(0, here)
        try:
            from make_external_fixtures import arrays
        finally:
            sys.path.pop(0)
        return here, arrays()

    @pytest.mark.parametrize("name,idx", [
        ("external_uint16_lzw_pred2.tif", 0),     # GDAL's int default
        ("external_float32_lzw_pred3.tif", 1),    # fp predictor
        ("external_uint8_deflate_pred2.tif", 2),
        ("external_int32_raw.tif", 3),
    ])
    def test_single_band_flavors_cell_exact(self, name, idx):
        import os
        here, arrs = self._fixtures()
        got = read_geotiff_band(os.path.join(here, name), 0)
        np.testing.assert_array_equal(got, arrs[idx].astype(np.float32))

    def test_chunky_multiband_multistrip(self):
        import os
        here, arrs = self._fixtures()
        rgb = arrs[4]
        path = os.path.join(here, "external_rgb_lzw_pred2_strips.tif")
        for b in range(3):
            got = read_geotiff_band(path, b)
            np.testing.assert_array_equal(
                got, rgb[:, :, b].astype(np.float32))

    def test_our_lzw_output_reads_in_external_decoder(self, tmp_path):
        """The inverse direction: a stock libtiff reader (Pillow) must
        decode this writer's LZW streams (the pre-round-5 width rule was
        nonstandard and rejected by libtiff)."""
        PIL = pytest.importorskip("PIL.Image")
        gc = make_grid_config(w=300.0, h=280.0)
        rng = np.random.default_rng(1)
        g = pcr.Grid.create(300, 280, [pcr.BandDesc(name="a")])
        arr = rng.normal(size=(280, 300)).astype(np.float32)
        g.set_band_array(0, arr)
        path = str(tmp_path / "ours.tif")
        assert write_geotiff(path, g, gc,
                             GeoTiffOptions(compress="LZW")).ok()
        got = np.array(PIL.open(path))
        np.testing.assert_array_equal(got, arr)

    def test_legacy_lzw_flavor_still_reads(self):
        """Streams from this library's pre-round-5 encoder (width bumps
        one step early) decode through the legacy fallback."""
        data = np.random.default_rng(4).integers(
            0, 256, 20000, dtype=np.uint8).tobytes()

        # miniature replica of the legacy encoder rule
        out = bytearray()
        bitbuf = nbits = 0
        code_width = 9

        def emit(code):
            nonlocal bitbuf, nbits
            bitbuf = (bitbuf << code_width) | code
            nbits += code_width
            while nbits >= 8:
                nbits -= 8
                out.append((bitbuf >> nbits) & 0xFF)
            bitbuf &= (1 << nbits) - 1

        table = {bytes([i]): i for i in range(256)}
        next_code = 258
        emit(256)
        w = b""
        for ch in data:
            wc = w + bytes([ch])
            if wc in table:
                w = wc
                continue
            emit(table[w])
            table[wc] = next_code
            next_code += 1
            if next_code == (1 << code_width) - 1:
                if code_width < 12:
                    code_width += 1
                else:
                    emit(256)
                    table = {bytes([i]): i for i in range(256)}
                    next_code = 258
                    code_width = 9
            w = bytes([ch])
        if w:
            emit(table[w])
        emit(257)
        if nbits:
            out.append((bitbuf << (8 - nbits)) & 0xFF)

        legacy_stream = bytes(out)
        assert lzw_decode(legacy_stream, legacy=True) == data
        # and the standard rule does NOT decode it fully (sanity)
        assert len(lzw_decode(legacy_stream)) != len(data)


class TestWriteRead:
    def test_single_band_roundtrip(self, tmp_path):
        gc = make_grid_config(w=64.0, h=48.0)
        g, arrays = make_grid(["elev"])
        path = str(tmp_path / "a.tif")
        assert write_geotiff(path, g, gc).ok()
        out = read_geotiff_band(path, 0)
        assert np.array_equal(out, arrays[0])

    def test_multiband_roundtrip(self, tmp_path):
        gc = make_grid_config(w=64.0, h=48.0)
        g, arrays = make_grid(["a", "b", "c"])
        path = str(tmp_path / "m.tif")
        assert write_geotiff(path, g, gc).ok()
        for i in range(3):
            assert np.array_equal(read_geotiff_band(path, i), arrays[i])

    @pytest.mark.parametrize("comp", ["NONE", "DEFLATE", "LZW", "ZSTD"])
    def test_compression_variants(self, tmp_path, comp):
        gc = make_grid_config(w=64.0, h=48.0)
        g, arrays = make_grid(["x"])
        path = str(tmp_path / f"{comp}.tif")
        assert write_geotiff(path, g, gc, GeoTiffOptions(compress=comp)).ok()
        assert np.array_equal(read_geotiff_band(path, 0), arrays[0])

    def test_nan_inf_preserved(self, tmp_path):
        gc = make_grid_config(w=4.0, h=1.0)
        g = pcr.Grid.create(4, 1, [pcr.BandDesc(name="x")])
        a = np.array([[np.nan, np.inf, -np.inf, 1.5]], np.float32)
        g.set_band_array(0, a)
        path = str(tmp_path / "nan.tif")
        assert write_geotiff(path, g, gc).ok()
        out = read_geotiff_band(path, 0)
        assert np.array_equal(out, a, equal_nan=True)

    def test_info_and_crs_preserved(self, tmp_path):
        gc = make_grid_config(w=64.0, h=48.0, epsg=32110)
        g, _ = make_grid(["x"])
        path = str(tmp_path / "crs.tif")
        assert write_geotiff(path, g, gc).ok()
        w, h, nb, crs, bounds = read_geotiff_info(path)
        assert (w, h, nb) == (64, 48, 1)
        assert crs.epsg == 32110
        assert bounds.min_x == 0.0 and bounds.max_y == 48.0
        assert bounds.max_x == 64.0 and bounds.min_y == 0.0

    def test_stripped_mode(self, tmp_path):
        gc = make_grid_config(w=64.0, h=48.0)
        g, arrays = make_grid(["x"])
        path = str(tmp_path / "strip.tif")
        opts = GeoTiffOptions(tile_width=0, tile_height=0, compress="DEFLATE")
        assert write_geotiff(path, g, gc, opts).ok()
        assert np.array_equal(read_geotiff_band(path, 0), arrays[0])

    def test_cog_overviews(self, tmp_path):
        gc = make_grid_config(w=600.0, h=600.0)
        rng = np.random.default_rng(0)
        g = pcr.Grid.create(600, 600, [pcr.BandDesc(name="x")])
        g.set_band_array(0, rng.random((600, 600)).astype(np.float32))
        path = str(tmp_path / "cog.tif")
        opts = GeoTiffOptions(cloud_optimized=True, compress="DEFLATE")
        assert write_geotiff(path, g, gc, opts).ok()
        # main band still reads exactly; file has extra IFDs
        from pcr_tpu.io.geotiff import _read_ifds
        images, _ = _read_ifds(path)
        assert len(images) > 1
        assert images[1].subfile_type == 1
        assert images[1].width == 300

    def test_missing_file(self):
        with pytest.raises(pcr.PcrError):
            read_geotiff_info("/nonexistent/file.tif")

    def test_device_grid_rejected(self, tmp_path):
        gc = make_grid_config(w=8.0, h=8.0)
        g = pcr.Grid.create(8, 8, [pcr.BandDesc(name="x")],
                            pcr.MemoryLocation.Device)
        st = write_geotiff(str(tmp_path / "d.tif"), g, gc)
        assert not st.ok()


class TestTiledWriter:
    def test_incremental_tiles(self, tmp_path):
        gc = make_grid_config(w=100.0, h=100.0, tile=40)
        path = str(tmp_path / "tiled.tif")
        writer = TiledGeoTiffWriter.open(path, gc, ["a"])
        rng = np.random.default_rng(1)
        expected = np.full((100, 100), np.nan, np.float32)
        for trow in range(gc.tiles_y):
            for tcol in range(gc.tiles_x):
                tile = pcr.TileIndex(row=trow, col=tcol)
                cs, rs, cc, rc = gc.tile_cell_range(tile)
                data = rng.random((1, rc, cc)).astype(np.float32)
                assert writer.write_tile(tile, data, 1).ok()
                expected[rs:rs + rc, cs:cs + cc] = data[0]
        assert writer.close().ok()
        out = read_geotiff_band(path, 0)
        assert np.array_equal(out, expected, equal_nan=True)

    def test_edge_tiles_and_missing_tiles_nan(self, tmp_path):
        gc = make_grid_config(w=100.0, h=100.0, tile=64)
        path = str(tmp_path / "edge.tif")
        writer = TiledGeoTiffWriter.open(path, gc, ["a"])
        # only write the edge tile (36x36)
        tile = pcr.TileIndex(row=1, col=1)
        data = np.ones((1, 36, 36), np.float32) * 2.0
        assert writer.write_tile(tile, data, 1).ok()
        assert writer.close().ok()
        out = read_geotiff_band(path, 0)
        assert (out[64:, 64:] == 2.0).all()
        assert np.isnan(out[:64, :64]).all()

    def test_band_count_mismatch(self, tmp_path):
        gc = make_grid_config(w=10.0, h=10.0)
        writer = TiledGeoTiffWriter.open(str(tmp_path / "x.tif"), gc, ["a"])
        st = writer.write_tile(pcr.TileIndex(), np.zeros((2, 10, 10)), 2)
        assert not st.ok()


def _legacy_lzw_encode(data: bytes) -> bytes:
    """Replica of the pre-round-5 encoder rule (width bumps one step
    early at every boundary)."""
    out = bytearray()
    bitbuf = nbits = 0
    code_width = 9

    def emit(code):
        nonlocal bitbuf, nbits
        bitbuf = (bitbuf << code_width) | code
        nbits += code_width
        while nbits >= 8:
            nbits -= 8
            out.append((bitbuf >> nbits) & 0xFF)
        bitbuf &= (1 << nbits) - 1

    table = {bytes([i]): i for i in range(256)}
    next_code = 258
    emit(256)
    w = b""
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = next_code
        next_code += 1
        if next_code == (1 << code_width) - 1:
            if code_width < 12:
                code_width += 1
            else:
                emit(256)
                table = {bytes([i]): i for i in range(256)}
                next_code = 258
                code_width = 9
        w = bytes([ch])
    if w:
        emit(table[w])
    emit(257)
    if nbits:
        out.append((bitbuf << (8 - nbits)) & 0xFF)
    return bytes(out)


class TestLegacyLzwFileFallback:
    """A WHOLE FILE from the pre-round-5 writer must read back through
    the production path (read_geotiff_band -> _decompress -> legacy
    fallback), including with the native decoder present — it rejects
    the desynced stream and the Python legacy rule recovers it."""

    def test_legacy_file_reads_cell_exact(self, tmp_path):
        import struct
        rng = np.random.default_rng(8)
        # big enough to cross the 9->10-bit width boundary
        arr = rng.integers(0, 256, (60, 101), dtype=np.uint8)
        payload = _legacy_lzw_encode(arr.tobytes())

        def E(entries, tag, typ, count, val):
            entries.append(struct.pack("<HHI4s", tag, typ, count, val))

        entries = []
        n = 9
        data_off = 8 + 2 + n * 12 + 4
        E(entries, 256, 3, 1, struct.pack("<I", 101))
        E(entries, 257, 3, 1, struct.pack("<I", 60))
        E(entries, 258, 3, 1, struct.pack("<I", 8))
        E(entries, 259, 3, 1, struct.pack("<I", 5))       # LZW
        E(entries, 262, 3, 1, struct.pack("<I", 1))
        E(entries, 273, 4, 1, struct.pack("<I", data_off))
        E(entries, 277, 3, 1, struct.pack("<I", 1))
        E(entries, 278, 3, 1, struct.pack("<I", 60))
        E(entries, 279, 4, 1, struct.pack("<I", len(payload)))
        blob = (b"II*\x00" + struct.pack("<I", 8)
                + struct.pack("<H", n) + b"".join(entries)
                + struct.pack("<I", 0) + payload)
        path = str(tmp_path / "legacy.tif")
        with open(path, "wb") as f:
            f.write(blob)
        got = read_geotiff_band(path, 0)
        np.testing.assert_array_equal(got, arr.astype(np.float32))


class TestRegistryGuards:
    def test_builtin_unregister_rejected(self):
        from pcr_tpu.ops.reduction import unregister_reduction
        with pytest.raises(ValueError):
            unregister_reduction(pcr.ReductionType.Sum)
        assert pcr.get_reduction_info(pcr.ReductionType.Sum) is not None


class TestCpuThreadsRestore:
    def test_default_config_restores_thread_default(self, monkeypatch):
        from pcr_tpu import native
        from conftest import make_grid_config
        calls = []
        monkeypatch.setattr(native, "set_num_threads",
                            lambda n: calls.append(n))
        gc = make_grid_config(w=10.0, h=10.0)
        for nthreads in (2, 0):
            cfg = pcr.PipelineConfig(
                grid=gc,
                reductions=[pcr.ReductionSpec(
                    value_channel="v", type=pcr.ReductionType.Sum)],
                exec_mode=pcr.ExecutionMode.CPU)
            cfg.cpu_threads = nthreads
            pcr.Pipeline.create(cfg)
        assert calls == [2, 0]   # default config RESTORES, not inherits

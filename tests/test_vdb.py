import numpy as np
import pytest

from nrc_hpm.utils.vdb import load_vdb


def test_cloud_grid_shape(cloud_grid):
    # file_bbox_min (-66,-21,-90), max (59,64,63) -> extent (126,86,154)
    assert tuple(cloud_grid.bbox_min) == (-66, -21, -90)
    assert tuple(cloud_grid.bbox_max) == (59, 64, 63)
    assert cloud_grid.data.shape == (126, 86, 154)


def test_cloud_grid_values(cloud_grid):
    d = cloud_grid.data
    # The reference asserts VDB density is normalized (Texture3D.cpp:74)
    assert d.max() == pytest.approx(1.0)
    assert d.min() == 0.0
    # nonzero voxel count must not exceed the file's active-voxel count
    assert 0 < (d != 0).sum() <= cloud_grid.metadata["file_voxel_count"]
    # cloud interior should be a contiguous blob: the middle slice is dense
    assert (d[63] > 0).mean() > 0.3


def test_cloud_metadata(cloud_grid):
    assert cloud_grid.name == "density"
    assert cloud_grid.metadata["class"] == "fog volume"
    assert cloud_grid.voxel_size == pytest.approx(3.3333, abs=1e-3)


def test_not_a_vdb(tmp_path):
    p = tmp_path / "x.vdb"
    p.write_bytes(b"garbage data that is not a vdb file at all")
    with pytest.raises(ValueError):
        load_vdb(str(p))


def test_missing_grid_name(wdas_vdb):
    with pytest.raises(ValueError):
        load_vdb(wdas_vdb, grid_name="nonexistent")


def test_native_loader_matches_python(cloud_grid, wdas_vdb):
    from nrc_hpm.utils import native
    if not native.available():
        pytest.skip("native/libnrcio.so not built")
    arr, bbox_min, voxel = native.vdb_load_native(wdas_vdb)
    assert arr.shape == cloud_grid.data.shape
    assert (bbox_min == cloud_grid.bbox_min).all()
    assert np.array_equal(arr, cloud_grid.data)
    assert voxel == pytest.approx(cloud_grid.voxel_size)

"""The generator draws the same drive from the same seed, another from
another, and no scan larger than the configuration's scan capacity."""
import json
import os

import numpy as np
import pytest

from mapbench import generator, manifest

TRAFFIC = {name[:-5]: json.load(open(os.path.join(
    manifest.HERE, "traffic", name)))
    for name in sorted(os.listdir(os.path.join(manifest.HERE, "traffic")))}


@pytest.mark.parametrize("mix", sorted(TRAFFIC))
@pytest.mark.parametrize("seed", [3, 2**31 + 17, -5])
def test_same_seed_same_drive(mix, seed):
    a = generator.render_drive(TRAFFIC[mix], 2000, 2048, 4, seed, "cpu")
    b = generator.render_drive(TRAFFIC[mix], 2000, 2048, 4, seed, "cpu")
    c = generator.render_drive(TRAFFIC[mix], 2000, 2048, 4, seed + 1, "cpu")
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[1], c[1])
    assert a[1].shape == (4, 2000, 4) and np.isfinite(a[1]).all()


def test_scan_larger_than_capacity_is_refused():
    with pytest.raises(ValueError):
        generator.render_drive(TRAFFIC["straight"], 4097, 4096, 2, 1, "cpu")


def test_every_cell_fits_its_scan_capacity():
    bench = manifest.load()
    for w in bench["workloads"]:
        c = manifest.cell(bench, w["name"])["config"]
        assert c["points_per_scan"] <= c["settings"][
            "map_builder.front_end.scan_capacity"]


def test_scans_are_in_the_sensor_frame_at_their_poses():
    tr = TRAFFIC["straight"]
    poses, scans = generator.render_drive(tr, 3000, 4096, 3, 9, "cpu")
    # the ground lies 1.8 m under every sensor, whatever its pose
    z = scans[:, :, 2]
    assert np.isclose(np.median(z[z < -1.5]), -tr["sensor"]["height_m"],
                      atol=0.01)
    r = np.linalg.norm(scans[:, :, :3], axis=2)
    assert r.max() <= tr["sensor"]["max_range_m"] + 0.1
    steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    assert np.all(np.abs(steps - tr["step_m"]) < 0.5)

"""Parity of the PyTorch port's chunked type-6 front end and pipelined
``MapBuilder`` (staticmapping_torch.builder) with the JAX package, on the
CPU: one ``DeviceFrontEnd`` chunk from the same state, the whole slice on a
short synthetic sequence, and the entry points' default device."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from staticmapping_tpu.builder import frame as jframe
from staticmapping_tpu.builder import frontend as jfrontend
from staticmapping_tpu.builder import map_builder as jmb
from staticmapping_tpu.builder import pipeline as jpipe
from staticmapping_tpu.io import kitti as jkitti
from staticmapping_tpu.io import synthetic
from staticmapping_torch import interop
from staticmapping_torch.builder import frame as tframe
from staticmapping_torch.builder import frontend as tfrontend
from staticmapping_torch.builder import map_builder as tmb
from staticmapping_torch.builder import pipeline as tpipe
from staticmapping_torch.data import cloud as tcloud
from staticmapping_torch.io import kitti as tkitti

CPU = "cpu"
# the settings of tests/test_pipeline.py::_build
FE = dict(scan_capacity=8192, nn_tile=512, max_iteration=40,
          motion_compensation=False, use_average=False, target_leaf_size=4)


@pytest.fixture(scope="module")
def straight_scans():
    """tests/test_pipeline.py's sequence: 20 scans, 1 m apart, seed 5."""
    return synthetic.make_sequence(n_scans=20, seed=5, trajectory="straight",
                                   step=1.0, max_points=8000, max_range=70.0)


def _options(pkg_frontend, pkg_frame, pkg_mb, out_dir, **front_end):
    return pkg_mb.MapBuilderOptions(
        front_end=pkg_frontend.FrontEndOptions(**{**FE, **front_end}),
        submap=pkg_frame.SubmapOptions(frame_count=2),
        submap_capacity=16384, submap_matcher_leaf_size=4,
        pipelined=True, pipeline_chunk=8, pair_match_batch=4,
        export_file_path=str(out_dir), output_mrvm=False,
        output_direct_combined_map=False)


def _seeded_frontends(scans, imu=None, **front_end):
    """The JAX front end after the first scan, the port's front end, and
    the next eight scans (with gyro rows ``imu``) packed into one chunk."""
    opts = {**FE, **front_end}
    fe_j = jpipe.DeviceFrontEnd(jfrontend.FrontEndOptions(**opts),
                                chunk_size=8)
    fe_j.process(0.0, scans[0])
    fe_t = tpipe.DeviceFrontEnd(tfrontend.FrontEndOptions(**opts),
                                chunk_size=8, device=CPU)
    fe_t.close()
    buf = [(0.1 * i, scans[i]) for i in range(1, 9)]
    chunk = jpipe._pack_chunk(buf, 0.0, 8, FE["scan_capacity"], imu)
    for a, b in zip(chunk, tpipe._pack_chunk(buf, 0.0, 8,
                                             FE["scan_capacity"], imu)):
        np.testing.assert_array_equal(a, b)
    return fe_j, fe_t, chunk


def test_one_chunk_matches_jax(straight_scans):
    """The JAX front end's state after the first scan, carried across by
    ``interop``, and the same packed chunk go through both packages.

    Leaves of 8 points: at 4 the raw-moment leaf normals are dominated by
    f32 rounding in both packages (a third of the leaves differ by more
    than 1e-3), and each keyframe's new target carries that into the next
    scans."""
    scans, _ = straight_scans
    fe_j, fe_t, (q, meta, imu) = _seeded_frontends(scans,
                                                   target_leaf_size=8)
    state_t = interop.fe_state(fe_j.state, CPU)
    _, (poses_j, scores_j, kf_j, _) = fe_j._run_chunk(
        fe_j.state, jnp.asarray(q), jnp.asarray(meta), jnp.asarray(imu))
    _, outputs = fe_t._run_chunk(
        state_t, torch.from_numpy(q), torch.from_numpy(meta),
        torch.from_numpy(imu), np.ones(8, dtype=bool))
    poses_t = torch.stack([o[0] for o in outputs]).numpy()
    np.testing.assert_allclose(poses_t, np.asarray(poses_j), atol=5e-3)
    assert [o[2] for o in outputs] == np.asarray(kf_j).tolist()
    np.testing.assert_allclose([float(o[1]) for o in outputs],
                               np.asarray(scores_j), atol=1e-3)


@pytest.mark.parametrize("use_imu", [False, True])
def test_each_step_matches_jax_with_motion_compensation(straight_scans,
                                                        use_imu):
    """The scan step with motion compensation and pose averaging on (the
    front end's defaults), each scan started from the JAX package's state:
    the pose, keyframe flag and carried velocities agree.  Over a whole
    chunk the two f32 trajectories drift apart through the velocity
    feedback, so each step is held on its own.  With ``use_imu`` the
    rotation prediction comes from ten gyro rows per scan."""
    scans, _ = straight_scans
    rng = np.random.default_rng(6)
    gyro = [[(0.01, *rng.normal(0.0, 0.02, 3)) for _ in range(10)]
            for _ in range(8)] if use_imu else None
    fe_j, fe_t, (q, meta, imu) = _seeded_frontends(
        scans, imu=gyro, target_leaf_size=8, motion_compensation=True,
        use_average=True, use_imu=use_imu)
    stamps, xyz, inten, mask, valid = jpipe._unpack_chunk(
        jnp.asarray(q), jnp.asarray(meta))
    stamps_t, xyz_t, inten_t, mask_t, _ = tpipe._unpack_chunk(
        torch.from_numpy(q), torch.from_numpy(meta))
    step_j = jax.jit(fe_j._step)
    state = fe_j.state
    for k in range(4):
        new_t, (pose_t, _, kf_t, _) = fe_t._step(
            interop.fe_state(state, CPU),
            (stamps_t[k], xyz_t[k], inten_t[k], mask_t[k],
             torch.from_numpy(imu[k])))
        state, (pose_j, _, kf_j, _) = step_j(
            state, (stamps[k], xyz[k], inten[k], mask[k], valid[k],
                    jnp.asarray(imu[k])))
        np.testing.assert_allclose(pose_t.numpy(), np.asarray(pose_j),
                                   atol=5e-3)
        assert kf_t == bool(kf_j)
        np.testing.assert_allclose(new_t.vel_lin.numpy(),
                                   np.asarray(state.vel_lin), atol=5e-2)


def _mean_translation_error(poses, gt):
    gt_t = np.stack([g[:3, 3] - gt[0][:3, 3] for g in gt[:len(poses)]])
    return float(np.linalg.norm(
        np.stack([p[:3, 3] for p in poses]) - gt_t, axis=1).mean())


def test_whole_slice_matches_jax(straight_scans, tmp_path):
    """The pipelined type-6 MapBuilder of both packages on the same scans:
    equal keyframe and submap counts, the port's error within the bound of
    tests/test_pipeline.py, and a kitti_pose.txt that parses."""
    scans, gt = straight_scans
    mb_j = jmb.MapBuilder(_options(jfrontend, jframe, jmb, tmp_path / "jax"))
    mb_t = tmb.MapBuilder(_options(tfrontend, tframe, tmb, tmp_path / "torch"),
                          device=CPU)
    for i, pts in enumerate(scans):
        mb_j.insert_pointcloud(i * 0.1, pts)
        mb_t.insert_pointcloud(i * 0.1, pts)
    mb_j.finish()
    mb_t.finish()
    assert len(mb_t.frame_poses()) == len(mb_j.frame_poses())
    assert len(mb_t.trajectory) == len(mb_j.trajectory)
    ate_j = _mean_translation_error(mb_j.frame_poses(), gt)
    ate_t = _mean_translation_error(mb_t.frame_poses(), gt)
    assert ate_t < max(2.0 * ate_j, 0.35), (ate_j, ate_t)
    written = tkitti.read_poses(str(tmp_path / "torch" / "kitti_pose.txt"))
    assert written.shape == (len(mb_t.trajectory), 4, 4)
    assert np.isfinite(written).all()
    np.testing.assert_allclose(written, np.stack(mb_t.submap_poses()),
                               atol=1e-6)
    # the same file format as the JAX package writes
    assert jkitti.read_poses(
        str(tmp_path / "torch" / "kitti_pose.txt")).shape == written.shape
    assert os.path.exists(tmp_path / "torch" / "path.csv")


def test_submap_offload_round_trip(tmp_path):
    """offload → cloud dropped from memory → reloaded on access, onto the
    submap's device."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    s = tframe.Submap(0, tframe.SubmapOptions(frame_count=1,
                                              enable_disk_saving=True),
                      capacity=1024, save_dir=str(tmp_path), device=CPU)
    s.insert_frame(tframe.Frame(stamp=1.0, cloud=tcloud.from_numpy(
        pts, capacity=1024, device=CPU), global_pose=np.eye(4)))
    before = tcloud.to_numpy(s.cloud)
    s.match_transform_to_next = np.eye(4)
    assert s.offload() and not s.cloud_in_memory
    assert os.path.exists(s._disk_path())
    after = tcloud.to_numpy(s.cloud)
    assert s.cloud_in_memory and s.cloud.device == torch.device(CPU)
    np.testing.assert_array_equal(after, before)


def test_memory_manager_offloads_inactive_submaps(tmp_path):
    rng = np.random.default_rng(1)
    traj = tframe.Trajectory(0)
    for k in range(6):
        s = tframe.Submap(k, tframe.SubmapOptions(frame_count=1,
                                                  enable_disk_saving=True),
                          capacity=512, save_dir=str(tmp_path), device=CPU)
        s.insert_frame(tframe.Frame(stamp=float(k), cloud=tcloud.from_numpy(
            rng.uniform(-5, 5, (100, 3)), capacity=512, device=CPU),
            global_pose=np.eye(4)))
        s.match_transform_to_next = np.eye(4)
        traj.append(s)
    mm = tframe.MemoryManager(traj, delay_seconds=1.0, keep_last=2)
    assert mm.tick(0.0) == 0
    assert mm.tick(2.0) == 4          # all but the last two aged past 1 s
    assert sum(s.cloud_in_memory for s in traj) == 2
    assert traj[0].cloud is not None and traj[0].cloud_in_memory


def test_entry_points_need_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmb.MapBuilder(tmb.MapBuilderOptions(pipelined=True))

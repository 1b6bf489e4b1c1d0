"""One rank of tests/test_torch_multidevice.py — not a test module.

    python tests/torch_multidevice_worker.py RANK WORLD PORT INPUTS OUT_DIR

Each rank joins a gloo group on the CPU through
``staticmapping_torch.parallel.multihost.initialize`` and runs the stages
of tests/multihost_worker.py through the port (it imports neither JAX nor
the JAX package):

  A. pair registration: the batch of INPUTS through ``align_pairs_sharded``
     and, as this rank's half, through ``align_pairs_multihost``; five
     pairs through ``align_pair_list(mesh=)`` and unsharded; the mesh of
     ``make_submap_mesh(1)``;
  B. pose graph: the 64-node graph's solver arguments through
     ``solve_pose_graph_multihost`` with this rank's half of the between
     factors; the 400-node circuit through ``PoseGraph.optimize(
     solver="pcg", mesh=)``;
  C. the slice as a whole: this rank's half of a 22-scan straight world
     through the port's ``MapBuilder``, the boundary submaps and the
     per-half odometry exchanged with ``all_gather``, the boundary
     registered, and the merged graph solved sharded and in this process
     alone.

Every collective fails after the group's timeout.  The results go to
OUT_DIR/rank<RANK>.npz.
"""
import datetime
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from staticmapping_torch import interop  # noqa: E402
from staticmapping_torch.backend.pose_graph import PoseGraph  # noqa: E402
from staticmapping_torch.backend.pose_graph_sparse import (  # noqa: E402
    gauss_newton_pcg)
from staticmapping_torch.common import np_se3  # noqa: E402
from staticmapping_torch.data.cloud import PointCloud  # noqa: E402
from staticmapping_torch.parallel import multihost  # noqa: E402
from staticmapping_torch.parallel.align_pairs import (  # noqa: E402
    align_pair_list, align_pairs_sharded, make_submap_mesh)

CPU = "cpu"
CLOUD = ("xyz", "intensity", "factor", "mask")
NORMALS = ("xyz", "normals", "mask")
TIMEOUT = datetime.timedelta(seconds=45)
# stage C's boundary cloud capacity and its cap on submaps a half
BOUNDARY_CAPACITY = 4096
MAX_SUBMAPS = 16


def _rows(cloud, rows):
    return type(cloud)(**{f: getattr(cloud, f)[rows]
                          for f in (CLOUD if isinstance(cloud, PointCloud)
                                    else NORMALS)})


def stage_a(mesh, inp, out):
    src = interop.point_cloud({f: inp["a_src_" + f] for f in CLOUD}, CPU)
    tgt = interop.normal_cloud({f: inp["a_tgt_" + f] for f in NORMALS}, CPU)
    gs = torch.from_numpy(inp["a_guess"])
    Ts, scores, mean = align_pairs_sharded(src, tgt, gs, mesh,
                                           max_iteration=15)
    out.update(a_Ts=Ts.numpy(), a_scores=scores.numpy(),
               a_mean=float(mean))
    per = gs.shape[0] // mesh.size
    mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
    Ts_l, sc_l, mean_l = multihost.align_pairs_multihost(
        _rows(src, mine), _rows(tgt, mine), gs[mine], mesh, max_iteration=15)
    out.update(a_local_Ts=Ts_l, a_local_scores=sc_l, a_local_mean=mean_l)
    # five pairs: padded to six, three a rank
    srcs = [_rows(src, k) for k in range(5)]
    tgts = [_rows(tgt, k) for k in range(5)]
    guesses = [g for g in inp["a_guess"][:5]]
    Ts_m, sc_m = align_pair_list(srcs, tgts, guesses, mesh=mesh,
                                 max_iteration=15)
    Ts_1, sc_1 = align_pair_list(srcs, tgts, guesses, max_iteration=15)
    out.update(a_list_Ts=np.stack(Ts_m), a_list_scores=np.array(sc_m),
               a_list_ref_Ts=np.stack(Ts_1), a_list_ref_scores=np.array(sc_1))
    # a mesh over the first rank only: rank 1 is outside it
    first = make_submap_mesh(1, device=CPU)
    out["a_first_mesh"] = (-1 if first is None
                           else first.size * 10 + first.rank)


def stage_b(mesh, inp, out):
    n_args = int(inp["b_nargs"])
    args = interop.solver_args([inp[f"b_arg{k:02d}"] for k in range(n_args)],
                               CPU)
    fcap = args[2].shape[0]
    per = fcap // mesh.size
    mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
    factor_args = tuple(a[mine] for a in args[2:7]) + tuple(args[7:])
    poses, chi2, _ = multihost.solve_pose_graph_multihost(
        mesh, args[0], args[1], factor_args, num_iters=4)
    out.update(b_poses=poses, b_chi2=chi2)

    g = PoseGraph(device=CPU)
    odom = inp["b2_odom"]
    for _ in range(len(odom)):
        g.add_node()
    for k, nr in enumerate(inp["b2_noisy"]):
        g.add_between(k, k + 1, nr)
    for (i, j), T in zip(inp["b2_loop_ij"], inp["b2_loop_T"]):
        g.add_between(int(i), int(j), T, sigmas=(0.05,) * 3 + (0.02,) * 3)
    out["b2_poses"] = g.optimize(odom, num_iters=5, solver="pcg", mesh=mesh)
    out["b2_chi2"] = g.last_chi2


def _build_half(scans, idx):
    from staticmapping_torch.builder.frame import SubmapOptions
    from staticmapping_torch.builder.frontend import FrontEndOptions
    from staticmapping_torch.builder.map_builder import (MapBuilder,
                                                         MapBuilderOptions)
    opts = MapBuilderOptions(
        front_end=FrontEndOptions(scan_capacity=4096, nn_tile=512,
                                  max_iteration=30, target_leaf_size=4,
                                  motion_compensation=False,
                                  use_average=False),
        submap=SubmapOptions(frame_count=2),
        submap_capacity=8192, pair_match_batch=2,
        submap_matcher_leaf_size=4)
    mb = MapBuilder(opts, device=CPU)
    for k, i in enumerate(idx):
        mb.insert_pointcloud(k * 0.1, scans[i])
    mb._flush_pair_matches(drain=True)
    return mb


def stage_c(mesh, out):
    from staticmapping_torch.builder.frontend import _target_normals
    from staticmapping_torch.data import cloud as cloud_lib
    from staticmapping_torch.io import synthetic
    from staticmapping_torch.registration.icp_fast import (
        align_point_to_plane)

    scans, _ = synthetic.make_sequence(
        n_scans=22, seed=13, trajectory="straight", step=1.0,
        max_points=4000, max_range=60.0)
    halves = (list(range(0, 12)), list(range(10, 22)))
    mine = _build_half(scans, halves[mesh.rank])

    # rank 0 exports its last submap, rank 1 its first: the overlap
    s = mine.trajectory[len(mine.trajectory) - 1 if mesh.rank == 0 else 0]
    xyz = s.cloud.xyz[s.cloud.mask][:BOUNDARY_CAPACITY]
    pts = torch.zeros((BOUNDARY_CAPACITY, 3), dtype=torch.float32)
    pts[:len(xyz)] = xyz
    all_pts = multihost.all_gather(pts[None], mesh).numpy()
    all_n = multihost.all_gather(torch.tensor([len(xyz)]), mesh).numpy()

    # per-half odometry (each submap's match to the next), padded to one
    # shape for the gather
    rels = np.tile(np.eye(4, dtype=np.float32), (MAX_SUBMAPS, 1, 1))
    count = len(mine.trajectory) - 1
    for k, sm in enumerate(mine.trajectory[:-1]):
        rels[k] = sm.match_transform_to_next
    all_rels = multihost.all_gather(torch.from_numpy(rels)[None],
                                    mesh).numpy().astype(np.float64)
    counts = multihost.all_gather(torch.tensor([count]), mesh).numpy()

    tgt = cloud_lib.from_numpy(all_pts[0][:all_n[0]], capacity=4096,
                               device=CPU)
    src = cloud_lib.from_numpy(all_pts[1][:all_n[1]], capacity=4096,
                               device=CPU)
    T_cross, _ = align_point_to_plane(
        src, _target_normals(tgt, leaf_size=4),
        torch.eye(4, dtype=torch.float32), max_iteration=40, tile=512)
    T_cross = T_cross.double().numpy()

    s0, s1 = int(counts[0]) + 1, int(counts[1]) + 1
    g = PoseGraph(device=CPU)
    for _ in range(s0 + s1):
        g.add_node()
    for k in range(s0 - 1):
        g.add_between(k, k + 1, all_rels[0][k])
    g.add_between(s0 - 1, s0, T_cross)
    for k in range(s1 - 1):
        g.add_between(s0 + k, s0 + k + 1, all_rels[1][k])
    init = [np.eye(4)]
    for k in range(s0 - 1):
        init.append(np_se3.normalize_rotation(init[-1] @ all_rels[0][k]))
    init.append(np_se3.normalize_rotation(init[-1] @ T_cross))
    for k in range(s1 - 1):
        init.append(np_se3.normalize_rotation(init[-1] @ all_rels[1][k]))

    gargs, _, _ = g.solver_args(np.stack(init))
    ref_p, ref_c, _ = gauss_newton_pcg(*gargs, num_iters=4)
    per = gargs[2].shape[0] // mesh.size
    shard = slice(mesh.rank * per, (mesh.rank + 1) * per)
    mh_p, mh_c, _ = multihost.solve_pose_graph_multihost(
        mesh, gargs[0], gargs[1],
        tuple(a[shard] for a in gargs[2:7]) + tuple(gargs[7:]), num_iters=4)
    out.update(c_poses=mh_p, c_ref_poses=ref_p.numpy(), c_chi2=mh_c,
               c_ref_chi2=float(ref_c), c_nodes=s0 + s1)


def main() -> int:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    inputs, out_dir = sys.argv[4:6]
    torch.set_num_threads(2)
    multihost.initialize(f"localhost:{port}", world, rank, timeout=TIMEOUT,
                         device=CPU)
    mesh = multihost.global_mesh(device=CPU)
    assert (mesh.size, mesh.rank) == (world, rank), mesh
    inp = dict(np.load(inputs))
    out = {}
    stage_a(mesh, inp, out)
    stage_b(mesh, inp, out)
    stage_c(mesh, out)
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

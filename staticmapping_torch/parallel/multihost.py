"""Multi-process execution over ``torch.distributed`` — the PyTorch
counterpart of ``staticmapping_tpu.parallel.multihost``.

The reference is a single process; the JAX package scales out with a mesh
over every chip of every host, running its ``shard_map`` programs with
``psum``/``pmean``.  The port follows PyTorch's SPMD idiom instead: one
process per device, every rank runs the same code, and a collective over
the rank group stands where the JAX package has ``psum`` or gathers a
sharded array:

* :func:`initialize` joins the process group (NCCL between CUDA devices,
  gloo on the CPU), with a short timeout so that a hung rank fails the
  run instead of stalling it;
* :class:`Mesh` is the 1-D mesh over a group of ranks, :func:`global_mesh`
  the one over every rank;
* :func:`all_reduce` (the ``psum``) and :func:`all_gather` (a sharded
  array gathered along axis 0, in rank order) are the collectives the
  sharded pair registration and the sharded PCG solve use;
* :func:`align_pairs_multihost` and :func:`solve_pose_graph_multihost`
  are the entry points for callers that hold only their own shard.

Only the pipeline seams communicate: the pair batch's results and mean
score, and the PCG's partial sums (gradient, block diagonal, every
matvec, the costs).  The NN kernel and the 6×6 linearizations run on each
rank's own shard.

The mesh is a small class of the port's own, not
``torch.distributed.device_mesh.DeviceMesh``: a ``DeviceMesh`` whose
default group is gloo on a host with CUDA builds a new group with the
backend's default timeout (minutes), which would turn a hung rank back
into a stall, and it has no form for "the first n ranks" of
``make_submap_mesh``.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

# how long a collective waits for the other ranks before it fails
DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over ``size`` ranks of a process group: this process is
    rank ``rank`` of ``group`` and computes on ``device``."""

    group: object
    size: int
    rank: int
    device: torch.device
    axis_name: str = "submaps"


def require_group() -> None:
    """Raise unless this process has joined a process group."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: call "
            "staticmapping_torch.parallel.multihost.initialize(address, "
            "num_processes, process_id) in every process first (one "
            "process per device)")


def mesh_device(device) -> torch.device:
    """``device`` for a mesh of this process group: the current GPU unless
    named; an NCCL group takes only CUDA devices."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL group computes on CUDA devices, not {dev}")
    return dev


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT,
               device=None) -> torch.device:
    """Join the process group; call once in every process, before any
    collective.  ``coordinator_address`` is ``host:port`` (or a
    ``tcp://`` URL) of rank 0.  ``device`` is this process's device: the
    GPU unless named, ``cuda:<process_id mod the card count>`` when no
    index is given.  ``backend`` defaults to NCCL on a CUDA device and
    gloo otherwise; two ranks on one card need gloo, which NCCL refuses.
    Returns the device, made current on CUDA."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda",
                               process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    return dev


def global_mesh(axis_name: str = "submaps", device=None) -> Mesh:
    """The 1-D mesh over every rank of the process group, computing on
    ``device`` (the current GPU unless named)."""
    require_group()
    return Mesh(dist.group.WORLD, dist.get_world_size(), dist.get_rank(),
                mesh_device(device), axis_name)


def check_mesh(mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a staticmapping_torch.parallel.multihost.Mesh "
            f"(global_mesh, make_submap_mesh), not {type(mesh).__name__}")
    return mesh


def all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, on every rank (the JAX
    package's ``psum``).  ``x`` is summed in place and returned."""
    dist.all_reduce(x, group=mesh.group)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0 in rank order; each
    rank's ``x`` has the same shape."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def align_pairs_multihost(local_src, local_tgt, local_guesses, mesh: Mesh,
                          dist_outlier_ratio: float = 0.7,
                          max_iteration: int = 100,
                          exact_quantile: bool = False
                          ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Batched pair registration across processes.  Each rank passes its
    own ``(src, tgt, guess)`` stack (``align_pairs.stack_pairs``), all of
    one batch size, on ``mesh.device``.  Returns this rank's ``(Ts,
    scores)`` as numpy and the mean score over every rank's pairs, the
    same float on every rank."""
    from .align_pairs import _align_shard
    Ts, scores, mean_score = _align_shard(
        local_src, local_tgt, local_guesses, check_mesh(mesh),
        dist_outlier_ratio=dist_outlier_ratio, max_iteration=max_iteration,
        exact_quantile=exact_quantile)
    return (Ts.cpu().numpy(), scores.cpu().numpy(),
            float(mean_score.cpu()))


def _on_device(a, device: torch.device):
    """A numpy array as a tensor on ``device`` (integers as int64, the
    port's index type); tensors move there, numbers stay numbers."""
    if isinstance(a, np.ndarray):
        if a.ndim == 0:
            return a.item()
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if torch.is_tensor(a):
        return a.to(device)
    return a


def solve_pose_graph_multihost(mesh: Mesh, poses, node_mask, factor_args,
                               **solver_kwargs):
    """Distributed pose-graph solve across processes.  ``factor_args`` is
    the ``(fi, fj, T_meas, inv_sigmas, fmask, …)`` tail of
    ``PoseGraph.solver_args``: its first five arrays are this rank's own
    shard of the between factors, the rest and ``poses``, ``node_mask``
    are the same on every rank.  Arrays may be numpy or tensors.  Returns
    ``(poses, chi2, trace)`` as numpy and a float, the same on every
    rank."""
    from ..backend.pose_graph_sparse import _pcg_core
    check_mesh(mesh)
    args = [_on_device(a, mesh.device) for a in (poses, node_mask,
                                                 *factor_args)]
    out, chi2, trace = _pcg_core(*args, mesh=mesh, **solver_kwargs)
    return out.cpu().numpy(), float(chi2.cpu()), trace.cpu().numpy()

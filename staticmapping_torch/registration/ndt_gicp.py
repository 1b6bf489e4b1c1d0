"""NdtWithGicp — the PyTorch counterpart of
``staticmapping_tpu.registration.ndt_gicp``: the "type 3" matcher, NDT
coarse alignment chained into GICP refinement (registrators/
ndt_gicp.cc:55-112).

  * optional voxel downsample of both clouds first
    (``using_voxel_filter`` / ``voxel_resolution``, ndt_gicp.cc:31-36,
    59-77);
  * NDT stage if ``use_ndt`` (eps 0.01, res 1.0, 35 iterations,
    cc:46-49); its result is GICP's initial guess (cc:86-89);
  * GICP stage (rotation eps 1e-3, 35 iterations, cc:51-52); score =
    exp(−fitness) (cc:104);
  * a failed NDT stage returns the caller's guess (cc:106-109): "failed"
    is an NDT score below ``ndt_min_score``, read once on the host.
"""
from __future__ import annotations

import dataclasses

import torch

from ..data.cloud import PointCloud
from ..ops.voxel import voxel_downsample
from .gicp import Gicp
from .ndt import Ndt


@dataclasses.dataclass
class NdtWithGicp:
    """Stateful chained matcher (options: ndt_gicp.cc:31-53)."""

    use_ndt: bool = True
    using_voxel_filter: bool = True
    voxel_resolution: float = 0.2
    ndt_resolution: float = 1.0
    ndt_min_score: float = 0.2
    max_iteration: int = 35

    TYPE = 3  # registrator::Type::kNdtWithGicp (interface.h:41-50)

    final_score: float = 0.0

    def __post_init__(self):
        self._ndt = Ndt(resolution=self.ndt_resolution,
                        max_iteration=self.max_iteration)
        self._gicp = Gicp(max_iteration=self.max_iteration)
        self._source = None
        self._target = None

    def _maybe_filter(self, cloud: PointCloud) -> PointCloud:
        if self.using_voxel_filter:
            return voxel_downsample(cloud, self.voxel_resolution)
        return cloud

    def set_input_source(self, cloud: PointCloud):
        self._source = self._maybe_filter(cloud)
        self._ndt.set_input_source(self._source)
        self._gicp.set_input_source(self._source)

    def set_input_target(self, target: PointCloud):
        self._target = self._maybe_filter(target)
        self._ndt.set_input_target(self._target)
        self._gicp.set_input_target(self._target)

    def align(self, guess: torch.Tensor):
        if self._source is None or self._target is None:
            raise ValueError("set the source and the target before align")
        guess = torch.as_tensor(guess, dtype=torch.float32,
                                device=self._source.device)
        ndt_guess = guess
        if self.use_ndt:
            T_ndt, ndt_score = self._ndt.align(guess)
            if float(ndt_score) < self.ndt_min_score:
                # NDT diverged: keep the caller's guess (cc:106-109)
                self.final_score = 0.0
                return guess, torch.zeros((), dtype=torch.float32,
                                          device=guess.device)
            ndt_guess = T_ndt
        T, score = self._gicp.align(ndt_guess)
        self.final_score = score
        return T, score

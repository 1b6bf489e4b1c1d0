"""IcpUsingPointMatcher-equivalent ("type 1") — the PyTorch counterpart of
``staticmapping_tpu.registration.icp_pm``, the reference's hard-coded
loop-closure verifier (back_end/loop_detector.cc:304).

The reference wraps libpointmatcher's default pipeline
(registrators/icp_pointmatcher.cc:166-247): RandomSampling(prob 0.9) on the
reading, SamplingSurfaceNormal(knn 7, ratio 0.1) on the reference,
KDTreeMatcher(knn 1), TrimmedDist(0.7), PointToPlane, Counter(150); final
score = exp(−mean matched distance), accept iff ≥ 0.6 (cc:139-148).  Here
the pipeline runs on the point-to-plane ICP of ``icp_fast``:
  * reading random sampling → deterministic hash thinning of the point
    index (keep probability 0.9);
  * reference SamplingSurfaceNormal → the leaf-split normal estimator at
    leaf 8;
  * Counter(150) → ``max_iteration`` 150.
"""
from __future__ import annotations

import dataclasses

import torch

from ..data.cloud import PointCloud
from ..ops.normals import estimate_normals
from .icp_fast import align_point_to_plane

_HASH_MUL = 2654435761
_U32 = 0xFFFFFFFF


def _hash_thin(cloud: PointCloud, keep_prob: float) -> PointCloud:
    """Deterministic ~keep_prob thinning by an integer hash of the point
    index (the RandomSamplingDataPointsFilter role, prob 0.9).  The hash is
    the JAX package's uint32 one, ``h = i·2654435761 mod 2³²; h ^= h >> 16``,
    computed in int64 and masked to 32 bits after the multiply, so the kept
    mask is the same bit for bit."""
    n = cloud.capacity
    h = (torch.arange(n, dtype=torch.int64, device=cloud.device)
         * _HASH_MUL) & _U32
    h = h ^ (h >> 16)
    keep = (h % 1000) < int(keep_prob * 1000)
    return cloud.with_mask(keep)


@dataclasses.dataclass
class IcpPointMatcher:
    """Stateful matcher with the PM default-pipeline knobs."""

    reading_sample_prob: float = 0.9
    normal_leaf_size: int = 8
    dist_outlier_ratio: float = 0.7   # TrimmedDistOutlierFilter ratio
    max_iteration: int = 150          # CounterTransformationChecker
    accept_min_score: float = 0.6     # icp_pointmatcher.cc:145-147

    TYPE = 1  # registrator::Type::kIcpPM (interface.h:41-50)

    _source: PointCloud = None
    _target = None
    final_score: float = 0.0

    def set_input_source(self, cloud: PointCloud):
        self._source = _hash_thin(cloud, self.reading_sample_prob)

    def set_input_target(self, target: PointCloud):
        self._target = estimate_normals(target.compact(),
                                        leaf_size=self.normal_leaf_size)

    def align(self, guess: torch.Tensor):
        if self._source is None or self._target is None:
            raise ValueError("set the source and the target before align")
        T, score = align_point_to_plane(
            self._source, self._target,
            torch.as_tensor(guess, dtype=torch.float32,
                            device=self._source.device),
            dist_outlier_ratio=self.dist_outlier_ratio,
            max_iteration=self.max_iteration)
        self.final_score = score
        return T, score

"""Point-to-plane ICP inputs made in torch alone (no JAX), shared by
tests/test_torch_icp.py (the CPU) and tests/test_torch_cuda.py (the GPU).
Not a test module.

A pair is a source and a target sampled apart from the same three
orthogonal planes (a floor and two walls, so every axis of the motion is
pinned), with 1 cm of noise, a tenth of each cloud's slots masked out,
and a guess 0.36 m off the truth."""
from typing import Optional

import torch

from staticmapping_torch.data.cloud import NormalCloud, PointCloud

_NORMALS = torch.eye(3)[[2, 0, 1]]      # floor z = 0, walls x = 5, y = -4


def _planes(g: torch.Generator, lead: tuple, k: int):
    u = torch.rand(lead + (k, 2), generator=g) * 20.0 - 10.0
    which = torch.randint(0, 3, lead + (k,), generator=g)
    zero = torch.zeros(lead + (k,))
    xyz = torch.stack([
        torch.stack([u[..., 0], u[..., 1], zero], -1),
        torch.stack([zero + 5.0, u[..., 0], u[..., 1]], -1),
        torch.stack([u[..., 0], zero - 4.0, u[..., 1]], -1)], -2)
    pick = which[..., None, None].expand(lead + (k, 1, 3))
    xyz = torch.gather(xyz, -2, pick)[..., 0, :]
    xyz = xyz + 0.01 * torch.randn(xyz.shape, generator=g)
    return xyz, _NORMALS[which]


def plane_pair(seed: int, nb: Optional[int], n: int, m: int,
               device="cpu"):
    """``(source, target, guess)``: one pair (``nb`` None) or a batch of
    ``nb``, ``n`` source and ``m`` target slots."""
    g = torch.Generator().manual_seed(seed)
    lead = () if nb is None else (nb,)
    src, _ = _planes(g, lead, n)
    tgt, nrm = _planes(g, lead, m)
    factor = torch.rand(lead + (n,), generator=g)
    smask = torch.rand(lead + (n,), generator=g) > 0.1
    tmask = torch.rand(lead + (m,), generator=g) > 0.1
    guess = torch.eye(4).expand(lead + (4, 4)).clone()
    guess[..., :3, 3] = torch.tensor([0.3, -0.2, 0.05])
    source = PointCloud(src, torch.zeros(lead + (n,)), factor, smask)
    target = NormalCloud(tgt, nrm, tmask)
    return (PointCloud(*(t.to(device) for t in (
                source.xyz, source.intensity, source.factor, source.mask))),
            NormalCloud(*(t.to(device) for t in (
                target.xyz, target.normals, target.mask))),
            guess.to(device))

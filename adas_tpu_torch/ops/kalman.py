"""The batched Kalman filter as device ops (port of
``adas_tpu/ops/kalman_jax.py``).

The host tracker's filter (``tracking/kalman.py``, itself the reference's
``kalman_filter.py:40-270``) on tensors: the same constant-velocity model
over (cx, cy, aspect, h) boxes, standard deviations 1/20 of the height for
position and 1/160 for velocity, and the Cholesky update, batched over a
(N, 8) mean and (N, 8, 8) covariance tensor on their own device, in their
own type (f32 on the card).  Rows past the live tracks carry states the
caller masks.

The predictions feed the host tracker through ``BYTETracker.update(
predicted=(means, covs))`` in place of its numpy ``multi_predict``.  JAX
retired its serving mode that ran ``predict`` inside the fused device step
(``adas_tpu/pipeline/multistream.py:119-133``: a predict that must see the
state its own fetch updates cannot pipeline), and so the port keeps these
as ops off the serving path.
"""
from __future__ import annotations

from typing import Tuple

import torch

_STD_POS = 1.0 / 20
_STD_VEL = 1.0 / 160
_NDIM = 4


def _motion_mat(like: torch.Tensor) -> torch.Tensor:
    f = torch.eye(2 * _NDIM, dtype=like.dtype, device=like.device)
    f[:_NDIM, _NDIM:] += torch.eye(_NDIM, dtype=like.dtype, device=like.device)
    return f


def _diag(std: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(std * std)


def initiate(measurements: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 4) xyah measurements -> (N, 8) means, (N, 8, 8) covariances
    (``kalman_jax.py:41``)."""
    h = measurements[:, 3]
    means = torch.cat([measurements, torch.zeros_like(measurements)], dim=1)
    std = torch.stack([
        2 * _STD_POS * h, 2 * _STD_POS * h, torch.full_like(h, 1e-2), 2 * _STD_POS * h,
        10 * _STD_VEL * h, 10 * _STD_VEL * h, torch.full_like(h, 1e-5), 10 * _STD_VEL * h,
    ], dim=1)
    return means, _diag(std)


def predict(means: torch.Tensor, covariances: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x' = F x, P' = F P F^T + Q(h) for every track at once
    (``kalman_jax.py:61``)."""
    f = _motion_mat(means)
    h = means[:, 3]
    std = torch.stack([
        _STD_POS * h, _STD_POS * h, torch.full_like(h, 1e-2), _STD_POS * h,
        _STD_VEL * h, _STD_VEL * h, torch.full_like(h, 1e-5), _STD_VEL * h,
    ], dim=1)
    return means @ f.T, f @ covariances @ f.T + _diag(std)


def project(means: torch.Tensor, covariances: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """H x, H P H^T + R into the (N, 4) measurement space
    (``kalman_jax.py:81``)."""
    h = means[:, 3]
    std = torch.stack([_STD_POS * h, _STD_POS * h, torch.full_like(h, 1e-1), _STD_POS * h], dim=1)
    return means[:, :_NDIM], covariances[:, :_NDIM, :_NDIM] + _diag(std)


def update(means: torch.Tensor, covariances: torch.Tensor,
           measurements: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The measurement update through batched Cholesky solves
    (``kalman_jax.py:93``): the gain K = P H^T S^-1 as the solve of
    S K^T = (P H^T)^T."""
    proj_means, proj_covs = project(means, covariances)
    pht = covariances[:, :, :_NDIM]  # H = [I 0]
    chol = torch.linalg.cholesky(proj_covs)
    gains = torch.cholesky_solve(pht.transpose(1, 2), chol).transpose(1, 2)
    innovation = measurements - proj_means
    new_means = means + torch.einsum("nij,nj->ni", gains, innovation)
    new_covs = covariances - torch.einsum("nij,njk,nlk->nil", gains, proj_covs, gains)
    return new_means, new_covs


def gating_distance(means: torch.Tensor, covariances: torch.Tensor,
                    measurements: torch.Tensor) -> torch.Tensor:
    """Squared Mahalanobis distance of M measurements to each of N tracks:
    (N, M) (``kalman_jax.py:117``)."""
    proj_means, proj_covs = project(means, covariances)
    chol = torch.linalg.cholesky(proj_covs)
    d = measurements[None] - proj_means[:, None]  # (N, M, 4)
    z = torch.linalg.solve_triangular(chol, d.transpose(1, 2), upper=False)
    return (z * z).sum(dim=1)

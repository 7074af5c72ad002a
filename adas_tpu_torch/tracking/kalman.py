"""Batched constant-velocity Kalman filter over (x, y, a, h) boxes.

Numerical parity with the reference filter
(ObjectTracker/byteTrack/dtypes/kalman_filter.py:40-270): 8-dim state
[cx, cy, aspect, h, v*], std weights 1/20 position and 1/160 velocity,
Cholesky-based update and Mahalanobis gating with the chi2 0.95 table.

Design difference: every operation here is *batched over tracks* as the
primary API — predict/update/gating take (N, 8) means and (N, 8, 8)
covariances and run as einsums, so the host tracker does one vectorized
call per frame instead of a Python loop (the reference vectorizes only
``multi_predict``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.linalg

#: 0.95 quantile of chi-square per dof, for Mahalanobis gating.
chi2inv95 = {
    1: 3.8415, 2: 5.9915, 3: 7.8147, 4: 9.4877, 5: 11.070,
    6: 12.592, 7: 14.067, 8: 15.507, 9: 16.919,
}

_NDIM = 4
_DT = 1.0


def _motion_mat() -> np.ndarray:
    f = np.eye(2 * _NDIM)
    f[:_NDIM, _NDIM:] = np.eye(_NDIM) * _DT
    return f


class KalmanFilter:
    """Batched CV Kalman filter; singleton-friendly (stateless)."""

    def __init__(self) -> None:
        self._F = _motion_mat()
        self._H = np.eye(_NDIM, 2 * _NDIM)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    # ---- single-track API (reference-compatible) ----

    def initiate(self, measurement: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        mean = np.r_[measurement, np.zeros(_NDIM)]
        h = measurement[3]
        wp, wv = self._std_weight_position, self._std_weight_velocity
        std = np.array([
            2 * wp * h, 2 * wp * h, 1e-2, 2 * wp * h,
            10 * wv * h, 10 * wv * h, 1e-5, 10 * wv * h,
        ])
        return mean, np.diag(std ** 2)

    def predict(self, mean, covariance):
        m, c = self.multi_predict(mean[None], covariance[None])
        return m[0], c[0]

    def project(self, mean, covariance):
        m, c = self.multi_project(mean[None], covariance[None])
        return m[0], c[0]

    def update(self, mean, covariance, measurement):
        m, c = self.multi_update(
            mean[None], covariance[None], measurement[None]
        )
        return m[0], c[0]

    def gating_distance(
        self, mean, covariance, measurements, only_position=False
    ) -> np.ndarray:
        """Squared Mahalanobis distance of K measurements to one track."""
        proj_mean, proj_cov = self.project(mean, covariance)
        if only_position:
            proj_mean, proj_cov = proj_mean[:2], proj_cov[:2, :2]
            measurements = measurements[:, :2]
        chol = np.linalg.cholesky(proj_cov)
        d = measurements - proj_mean
        z = scipy.linalg.solve_triangular(
            chol, d.T, lower=True, check_finite=False
        )
        return np.sum(z * z, axis=0)

    # ---- batched API (the hot path) ----

    def _motion_cov(self, means: np.ndarray) -> np.ndarray:
        h = means[:, 3]
        wp, wv = self._std_weight_position, self._std_weight_velocity
        std = np.stack([
            wp * h, wp * h, np.full_like(h, 1e-2), wp * h,
            wv * h, wv * h, np.full_like(h, 1e-5), wv * h,
        ], axis=1)
        n = means.shape[0]
        cov = np.zeros((n, 8, 8))
        idx = np.arange(8)
        cov[:, idx, idx] = std ** 2
        return cov

    def multi_predict(
        self, means: np.ndarray, covariances: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized predict over all tracks: x' = Fx, P' = FPFᵀ + Q."""
        means = np.asarray(means, dtype=np.float64)
        covariances = np.asarray(covariances, dtype=np.float64)
        q = self._motion_cov(means)
        new_means = means @ self._F.T
        new_covs = self._F @ covariances @ self._F.T + q
        return new_means, new_covs

    def multi_project(
        self, means: np.ndarray, covariances: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Project states into measurement space: Hx, HPHᵀ + R."""
        h = means[:, 3]
        wp = self._std_weight_position
        std = np.stack(
            [wp * h, wp * h, np.full_like(h, 1e-1), wp * h], axis=1
        )
        n = means.shape[0]
        r = np.zeros((n, 4, 4))
        idx = np.arange(4)
        r[:, idx, idx] = std ** 2
        proj_means = means[:, :_NDIM]
        proj_covs = covariances[:, :_NDIM, :_NDIM] + r
        return proj_means, proj_covs

    def multi_update(
        self,
        means: np.ndarray,
        covariances: np.ndarray,
        measurements: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized Kalman update: K = PHᵀS⁻¹ via per-track Cholesky."""
        means = np.asarray(means, dtype=np.float64)
        covariances = np.asarray(covariances, dtype=np.float64)
        measurements = np.asarray(measurements, dtype=np.float64)
        proj_means, proj_covs = self.multi_project(means, covariances)

        # S K^T = (P H^T)^T  solved per track with batched cholesky
        pht = covariances[:, :, :_NDIM]  # (N, 8, 4) since H = [I 0]
        chol = np.linalg.cholesky(proj_covs)  # (N, 4, 4)
        # solve S x = pht^T  -> x = S^-1 (H P)   (N, 4, 8)
        rhs = np.transpose(pht, (0, 2, 1))
        y = np.linalg.solve(chol, rhs)
        x = np.linalg.solve(np.transpose(chol, (0, 2, 1)), y)
        gain = np.transpose(x, (0, 2, 1))  # (N, 8, 4)

        innovation = measurements - proj_means  # (N, 4)
        new_means = means + np.einsum("nij,nj->ni", gain, innovation)
        new_covs = covariances - np.einsum(
            "nij,njk,nlk->nil", gain, proj_covs, gain
        )
        return new_means, new_covs

"""The port's EPnP in RANSAC (`neuman_tpu_torch.preprocess.pnp`) against
`cv2.solvePnPRansac(..., flags=cv2.SOLVEPNP_EPNP)` and `cv2.solvePnP(...,
flags=cv2.SOLVEPNP_EPNP)`, which the JAX alignment calls. cv2 is imported
here only: the port module does not import it.

Inputs: 54 points shaped like ROMP's joints (a body-sized cloud), a
1280x720 camera 3 m away, rotations and translations from a seed.
"""

import cv2
import numpy as np
import pytest

from neuman_tpu_torch.preprocess import pnp

K = np.array([[1100.0, 0.0, 640.0], [0.0, 1100.0, 360.0], [0.0, 0.0, 1.0]])
NUM_POINTS = 54
# clean projections: every correct EPnP recovers the exact pose, cv2's to
# ~1e-8 here (it undistorts the pixels to normalised coordinates and back)
CLEAN_ATOL = 1e-6
# 1 px noise and 20% gross outliers: the same inliers, and the final EPnP
# on them with OpenCV's control points (see pnp._jacobi_svd)
NOISY_DEG, NOISY_T_REL = 0.5, 0.01
# both against the truth at 1 px of noise on ~43 inliers
TRUTH_DEG, TRUTH_T_REL = 2.0, 0.05


def _rodrigues(rng, scale):
    r, _ = cv2.Rodrigues(rng.normal(size=3) * scale)
    return r


def _angle_deg(a, b):
    return float(np.degrees(np.arccos(np.clip((np.trace(a.T @ b) - 1) / 2, -1, 1))))


def _case(seed, noise=0.0, outlier_share=0.0):
    rng = np.random.default_rng(seed)
    p3 = rng.normal(size=(NUM_POINTS, 3)) * [0.25, 0.7, 0.15]
    r_true = _rodrigues(rng, 0.6)
    t_true = np.array([0.1, -0.2, 3.0]) + rng.normal(size=3) * 0.2
    cam = p3 @ r_true.T + t_true
    p2 = cam[:, :2] / cam[:, 2:] @ np.diag(K[[0, 1], [0, 1]]) + K[:2, 2]
    p2 = p2 + rng.normal(size=p2.shape) * noise
    outliers = rng.choice(NUM_POINTS, int(round(outlier_share * NUM_POINTS)), replace=False)
    p2[outliers] += rng.choice([-1.0, 1.0], size=(len(outliers), 2)) * rng.uniform(
        60, 200, size=(len(outliers), 2))
    return p3, p2, r_true, t_true, outliers


def _cv2_ransac(p3, p2):
    ok, rvec, tvec, inliers = cv2.solvePnPRansac(p3, p2, K, np.zeros(4), flags=cv2.SOLVEPNP_EPNP)
    assert ok
    return cv2.Rodrigues(rvec)[0], tvec[:, 0], np.sort(inliers[:, 0])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_clean_projections_match_cv2(seed):
    p3, p2, r_true, t_true, _ = _case(seed)
    r_cv, t_cv, inl_cv = _cv2_ransac(p3, p2)
    r, t, inliers = pnp.solve_pnp_ransac(p3, p2, K)
    np.testing.assert_allclose(r, r_cv, atol=CLEAN_ATOL)
    np.testing.assert_allclose(t, t_cv, atol=CLEAN_ATOL)
    np.testing.assert_array_equal(inliers, inl_cv)
    np.testing.assert_allclose(r, r_true, atol=1e-9)
    np.testing.assert_allclose(t, t_true, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_noise_and_outliers_match_cv2(seed):
    p3, p2, r_true, t_true, outliers = _case(seed, noise=1.0, outlier_share=0.2)
    r_cv, t_cv, inl_cv = _cv2_ransac(p3, p2)
    r, t, inliers = pnp.solve_pnp_ransac(p3, p2, K, seed=seed)
    np.testing.assert_array_equal(inliers, inl_cv)
    np.testing.assert_array_equal(inliers, np.setdiff1d(np.arange(NUM_POINTS), outliers))
    assert _angle_deg(r, r_cv) < NOISY_DEG
    assert np.linalg.norm(t - t_cv) < NOISY_T_REL * np.linalg.norm(t_cv)
    for rr, tt in ((r, t), (r_cv, t_cv)):
        assert _angle_deg(rr, r_true) < TRUTH_DEG
        assert np.linalg.norm(tt - t_true) < TRUTH_T_REL * np.linalg.norm(t_true)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_epnp_matches_cv2_on_noisy_points(seed):
    """EPnP alone on every point at 2 px of noise: OpenCV's control points
    give cv2's pose to float rounding (with numpy's SVD signs they differ
    by up to ~1 degree)."""
    p3, p2, _, _, _ = _case(seed, noise=2.0)
    ok, rvec, tvec = cv2.solvePnP(p3, p2, K, np.zeros(4), flags=cv2.SOLVEPNP_EPNP)
    r, t, err = pnp.epnp(p3, p2, K)
    np.testing.assert_allclose(r, cv2.Rodrigues(rvec)[0], atol=CLEAN_ATOL)
    np.testing.assert_allclose(t, tvec[:, 0], atol=CLEAN_ATOL)
    assert 0.5 < err < 4.0  # mean pixel error at 2 px of noise


def test_jacobi_svd_is_an_eigendecomposition():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(30, 3)) * [0.3, 1.0, 0.1]
    a = x.T @ x
    sv, rows = pnp._jacobi_svd(a)
    np.testing.assert_allclose(sv, np.linalg.eigvalsh(a)[::-1], rtol=1e-12)
    np.testing.assert_allclose(rows @ a, sv[:, None] * rows, atol=1e-10)
    np.testing.assert_allclose(rows @ rows.T, np.eye(3), atol=1e-12)


def test_too_few_points_raise():
    p3, p2, *_ = _case(0)
    with pytest.raises(ValueError):
        pnp.solve_pnp_ransac(p3[:4], p2[:4], K)
    r, t, inliers = pnp.solve_pnp_ransac(p3[:5], p2[:5], K)
    np.testing.assert_array_equal(inliers, np.arange(5))
    r_cv, t_cv, _ = _cv2_ransac(p3[:5], p2[:5])
    np.testing.assert_allclose(r, r_cv, atol=CLEAN_ATOL)

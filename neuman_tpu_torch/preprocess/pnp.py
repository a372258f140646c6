"""Camera pose from 3D-2D correspondences: EPnP inside RANSAC, in numpy.

The port's counterpart of `cv2.solvePnPRansac(object_points, image_points,
K, None, flags=cv2.SOLVEPNP_EPNP)` followed by `cv2.Rodrigues`, which the
JAX alignment calls (the machine with the GPU has no cv2).

EPnP (Lepetit, Moreno-Noguer and Fua, "EPnP: An Accurate O(n) Solution to
the PnP Problem", IJCV 2009), as OpenCV computes it:
  - four control points: the centroid of the object points and one step
    of sqrt(eigenvalue / n) along each principal axis; each point becomes
    barycentric weights (alphas) of the four. The axes' signs are those
    of OpenCV's one-sided Jacobi SVD (`_jacobi_svd`): on noisy points the
    least-squares solution depends on the control points, and another
    sign gives a pose up to ~1 degree away from cv2's at 2 px of noise;
  - the 2n x 12 system M in the control points' camera coordinates; its
    four right singular vectors of least singular value span the solution;
  - the scales (betas) of those vectors from the six control-point
    distances (L [6, 10] beta products = rho), approximated three ways
    (N = 1: B11, B12, B13, B14; N = 2: B11, B12, B22; N = 3: B11, B12, B22,
    B13, B23), each refined by 5 Gauss-Newton steps on all four betas;
  - for each, R and t by the SVD of the centred camera / object points
    (with OpenCV's sign fix of R's last row), and the mean reprojection
    error in pixels; the least error wins.

RANSAC as cv2's at its documented defaults: minimal sets of 5 points,
100 iterations, an inlier within 8 px (squared error <= 64), confidence
0.99 cutting the iterations as inliers are found; then EPnP on all the
best model's inliers. The inlier set is the best minimal model's, as
cv2's. The draws come from `np.random.default_rng(seed)` (cv2's own
generator differs; with consistent data the final EPnP decides the
result).
"""

import numpy as np

# cv2.solvePnPRansac's defaults
MODEL_POINTS, ITERATIONS, REPROJECTION_ERROR, CONFIDENCE = 5, 100, 8.0, 0.99
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _lstsq(a, b):
    return np.linalg.lstsq(a, b, rcond=None)[0]


def _betas_approx_1(l6x10, rho):
    b4 = _lstsq(l6x10[:, [0, 1, 3, 6]], rho)
    if b4[0] < 0:
        b0 = np.sqrt(-b4[0])
        return np.array([b0, -b4[1] / b0, -b4[2] / b0, -b4[3] / b0])
    b0 = np.sqrt(b4[0])
    return np.array([b0, b4[1] / b0, b4[2] / b0, b4[3] / b0])


def _betas_approx_2(l6x10, rho):
    b3 = _lstsq(l6x10[:, :3], rho)
    if b3[0] < 0:
        b0 = np.sqrt(-b3[0])
        b1 = np.sqrt(-b3[2]) if b3[2] < 0 else 0.0
    else:
        b0 = np.sqrt(b3[0])
        b1 = np.sqrt(b3[2]) if b3[2] > 0 else 0.0
    if b3[1] < 0:
        b0 = -b0
    return np.array([b0, b1, 0.0, 0.0])


def _betas_approx_3(l6x10, rho):
    b5 = _lstsq(l6x10[:, :5], rho)
    if b5[0] < 0:
        b0 = np.sqrt(-b5[0])
        b1 = np.sqrt(-b5[2]) if b5[2] < 0 else 0.0
    else:
        b0 = np.sqrt(b5[0])
        b1 = np.sqrt(b5[2]) if b5[2] > 0 else 0.0
    if b5[1] < 0:
        b0 = -b0
    return np.array([b0, b1, b5[3] / b0, 0.0])


def _gauss_newton(l6x10, rho, betas, iterations=5):
    """Refine the four betas on || L(beta products) - rho ||."""
    betas = betas.copy()
    for _ in range(iterations):
        b0, b1, b2, b3 = betas
        l = l6x10
        a = np.stack([
            2 * l[:, 0] * b0 + l[:, 1] * b1 + l[:, 3] * b2 + l[:, 6] * b3,
            l[:, 1] * b0 + 2 * l[:, 2] * b1 + l[:, 4] * b2 + l[:, 7] * b3,
            l[:, 3] * b0 + l[:, 4] * b1 + 2 * l[:, 5] * b2 + l[:, 8] * b3,
            l[:, 6] * b0 + l[:, 7] * b1 + l[:, 8] * b2 + 2 * l[:, 9] * b3,
        ], axis=1)
        products = np.array([b0 * b0, b0 * b1, b1 * b1, b0 * b2, b1 * b2, b2 * b2,
                             b0 * b3, b1 * b3, b2 * b3, b3 * b3])
        betas = betas + _lstsq(a, rho - l @ products)
    return betas


def _jacobi_svd(a):
    """(singular values, rows of U^T) of a small square matrix by OpenCV's
    one-sided Jacobi SVD (JacobiSVDImpl_): plane rotations of the columns
    from the identity, then the columns sorted by norm, largest first."""
    at = np.array(a, np.float64).T.copy()
    n = at.shape[0]
    w = np.sum(at * at, axis=1)
    eps = np.finfo(np.float64).eps * 10
    for _ in range(max(n, 30)):
        changed = False
        for i in range(n - 1):
            for j in range(i + 1, n):
                p = float(at[i] @ at[j])
                if abs(p) <= eps * np.sqrt(w[i] * w[j]):
                    continue
                p *= 2
                beta = w[i] - w[j]
                gamma = np.hypot(p, beta)
                if beta < 0:
                    s = np.sqrt((gamma - beta) * 0.5 / gamma)
                    c = p / (gamma * s * 2)
                else:
                    c = np.sqrt((gamma + beta) / (gamma * 2))
                    s = p / (gamma * c * 2)
                at[i], at[j] = c * at[i] + s * at[j], -s * at[i] + c * at[j]
                w[i], w[j] = at[i] @ at[i], at[j] @ at[j]
                changed = True
        if not changed:
            break
    sv = np.sqrt(np.sum(at * at, axis=1))
    order = list(range(n))
    for i in range(n - 1):  # OpenCV's selection sort: the first largest wins
        j = i
        for k in range(i + 1, n):
            if sv[order[j]] < sv[order[k]]:
                j = k
        order[i], order[j] = order[j], order[i]
    return sv[order], at[order] / sv[order][:, None]


def _project(r, t, points, k):
    cam = points @ r.T + t
    return np.stack([k[0, 2] + k[0, 0] * cam[:, 0] / cam[:, 2],
                     k[1, 2] + k[1, 1] * cam[:, 1] / cam[:, 2]], axis=1)


def epnp(object_points, image_points, k):
    """(R [3, 3], t [3], mean reprojection error in pixels) of n >= 4
    correspondences: object points [n, 3], pixels [n, 2], intrinsics K."""
    pws = np.asarray(object_points, np.float64).reshape(-1, 3)
    us = np.asarray(image_points, np.float64).reshape(-1, 2)
    k = np.asarray(k, np.float64)
    n = len(pws)
    if n < 4 or len(us) != n:
        raise ValueError(f"EPnP takes n >= 4 matching points, got {n} and {len(us)}")
    fu, fv, uc, vc = k[0, 0], k[1, 1], k[0, 2], k[1, 2]

    # control points: the centroid, then a step along each principal axis
    c0 = pws.mean(axis=0)
    dc, uct = _jacobi_svd((pws - c0).T @ (pws - c0))
    cws = np.concatenate([c0[None], c0 + np.sqrt(dc / n)[:, None] * uct])
    cc_inv = np.linalg.pinv((cws[1:] - c0).T)
    a123 = (pws - c0) @ cc_inv.T
    alphas = np.concatenate([1.0 - a123.sum(axis=1, keepdims=True), a123], axis=1)

    m = np.zeros((2 * n, 12))
    m[0::2, 0::3] = alphas * fu
    m[0::2, 2::3] = alphas * (uc - us[:, :1])
    m[1::2, 1::3] = alphas * fv
    m[1::2, 2::3] = alphas * (vc - us[:, 1:])
    _, _, ut = np.linalg.svd(m.T @ m)
    v = ut[[11, 10, 9, 8]].reshape(4, 4, 3)  # the null-space basis, control point, xyz

    l6x10 = np.zeros((6, 10))
    rho = np.zeros(6)
    for j, (a, b) in enumerate(_PAIRS):
        dv = v[:, a] - v[:, b]  # [4, 3]
        d = dv @ dv.T
        l6x10[j] = [d[0, 0], 2 * d[0, 1], d[1, 1], 2 * d[0, 2], 2 * d[1, 2], d[2, 2],
                    2 * d[0, 3], 2 * d[1, 3], 2 * d[2, 3], d[3, 3]]
        rho[j] = np.sum((cws[a] - cws[b]) ** 2)

    best = None
    for approx in (_betas_approx_1, _betas_approx_2, _betas_approx_3):
        betas = _gauss_newton(l6x10, rho, approx(l6x10, rho))
        ccs = np.einsum("i,ijk->jk", betas, v)
        pcs = alphas @ ccs
        if pcs[0, 2] < 0:
            pcs = -pcs
        pc0, pw0 = pcs.mean(axis=0), pws.mean(axis=0)
        u, _, vt = np.linalg.svd((pcs - pc0).T @ (pws - pw0))
        r = u @ vt
        if np.linalg.det(r) < 0:
            r[2] = -r[2]
        t = pc0 - r @ pw0
        err = np.mean(np.linalg.norm(us - _project(r, t, pws, k), axis=1))
        if best is None or err < best[2]:
            best = (r, t, err)
    return best


def _ransac_iterations(confidence, outlier_share, model_points, max_iters):
    """cv2's RANSACUpdateNumIters."""
    num = max(1.0 - min(max(confidence, 0.0), 1.0), np.finfo(np.float64).tiny)
    denom = 1.0 - (1.0 - min(max(outlier_share, 0.0), 1.0)) ** model_points
    if denom < np.finfo(np.float64).tiny:
        return 0
    num, denom = np.log(num), np.log(denom)
    if denom >= 0 or -num >= max_iters * (-denom):
        return max_iters
    return int(np.rint(num / denom))


def solve_pnp_ransac(object_points, image_points, k, seed=0):
    """(R [3, 3], t [3], inlier indices): EPnP on the inliers of the best
    EPnP model of 5 random correspondences (see the module docstring)."""
    pws = np.asarray(object_points, np.float64).reshape(-1, 3)
    us = np.asarray(image_points, np.float64).reshape(-1, 2)
    n = len(pws)
    if n < MODEL_POINTS or len(us) != n:
        raise ValueError(f"PnP RANSAC takes n >= {MODEL_POINTS} matching points, "
                         f"got {n} and {len(us)}")
    if n == MODEL_POINTS:
        r, t, _ = epnp(pws, us, k)
        return r, t, np.arange(n)
    rng = np.random.default_rng(seed)
    thresh2 = REPROJECTION_ERROR ** 2
    best_count, best_mask = 0, None
    max_iters, it = ITERATIONS, 0
    while it < max_iters:
        subset = rng.choice(n, MODEL_POINTS, replace=False)
        r, t, _ = epnp(pws[subset], us[subset], k)
        mask = np.sum((_project(r, t, pws, k) - us) ** 2, axis=1) <= thresh2
        count = int(mask.sum())
        if count > max(best_count, MODEL_POINTS - 1):
            best_count, best_mask = count, mask
            max_iters = _ransac_iterations(CONFIDENCE, (n - count) / n, MODEL_POINTS, max_iters)
        it += 1
    if best_mask is None:
        raise ValueError("PnP RANSAC found no model with 5 or more inliers")
    r, t, _ = epnp(pws[best_mask], us[best_mask], k)
    return r, t, np.flatnonzero(best_mask)

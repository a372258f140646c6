"""Smooth watertight body-proxy mesh (the port's copy of the mesh builder
in neuman_tpu/utils/synthetic_body.py, numpy only).

A subdivided icosphere with low-frequency radial lumps, scaled to body
proportions; at subdivisions=5 it has V=10,242 and F=20,480, within 1.5x
of SMPL's 6,890 vertices. `models/smpl.body_proxy_smpl_model` rigs it.
"""

import numpy as np


def _icosahedron():
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    return verts, faces


def _subdivide(verts, faces):
    """Midpoint subdivision, re-projected to the unit sphere."""
    verts = list(map(tuple, verts))
    cache = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key not in cache:
            m = np.asarray(verts[i]) + np.asarray(verts[j])
            m /= np.linalg.norm(m)
            cache[key] = len(verts)
            verts.append(tuple(m))
        return cache[key]

    out = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        out += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    return np.asarray(verts), np.asarray(out, dtype=np.int64)


def synthetic_body_mesh(subdivisions=4, seed=0):
    """Watertight smooth body-proxy mesh (subdivided icosphere, deformed).

    Vertex degree <= 6 (SMPL's max incidence is 9), so the KNN candidate
    sets are comparable. Sizes bracket SMPL (V=6890, F=13776):
    subdivisions=4 -> V=2562, F=5120; subdivisions=5 -> V=10242, F=20480.

    Surface: unit icosphere -> smooth low-frequency radial modulation
    (shoulder/hip/limb-scale lumps) -> anisotropic scale to body
    proportions (in the 3.14-normalized NeuMan scene scale a standing body
    spans ~1.5 units tall, ~0.5 wide, ~0.25 deep —
    data_io/neuman_helper.py:229-244).
    """
    rng = np.random.default_rng(seed)
    verts, faces = _icosahedron()
    for _ in range(subdivisions):
        verts, faces = _subdivide(verts, faces)

    theta = np.arccos(np.clip(verts[:, 1], -1, 1))  # polar from +y
    phi = np.arctan2(verts[:, 2], verts[:, 0])
    r = np.ones(len(verts))
    for _ in range(3):
        l_t = rng.integers(1, 4)
        l_p = rng.integers(1, 4)
        amp = rng.uniform(0.05, 0.15)
        r += amp * np.sin(l_t * theta + rng.uniform(0, np.pi)) * np.cos(
            l_p * phi + rng.uniform(0, np.pi)
        )
    verts = verts * r[:, None]
    # body proportions (x: width, y: height, z: depth)
    verts = verts * np.array([0.25, 0.75, 0.125])
    return verts.astype(np.float32), faces.astype(np.int32)

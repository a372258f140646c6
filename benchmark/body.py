"""The body every human cell uses: a closed, body-shaped mesh at SMPL's
published sizes, rigged with SMPL's kinematic tree.

SMPL (Loper et al. 2015) has V = 6,890 vertices, F = 13,776 faces, 24
joints and 10 shape coefficients. Its weights are a licensed download, so
this module builds a stand-in of exactly those counts, the same for every
seed (as SMPL's template is):

- the surface is 106 rings of 65 vertices (106 x 65 = 6,890), each ring an
  ellipse whose half-width and half-depth follow a body's profile by
  height (feet, shins, knees, thighs, hips, waist, chest, shoulders, neck
  and head, 1.7 units tall), the bands between rings split into triangles
  and the top and bottom rings closed by zig-zag strips, so that no vertex
  meets more than 6 faces (SMPL's most is 9) and the closed surface has
  2 x 6,890 - 4 = 13,776 faces;
- 24 joints at a body's joint positions, with SMPL's parents;
- a joint regressor whose row j averages the vertices of a band around
  joint j's height, weighted towards the joint's side, so that each joint
  lies inside the body near its place;
- skin weights local to each vertex's four nearest joints, falling off
  with distance;
- ten smooth shape directions.

numpy only; `model()` returns the arrays every side of a cell takes.
"""

import numpy as np

NUM_VERTS = 6890
NUM_FACES = 13776
RINGS, SEGMENTS = 106, 65
HEIGHT = 1.7
NUM_BETAS = 10

# SMPL's kinematic tree (kintree_table[0], the root's parent -1)
PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)
# a body's joints in SMPL's order (x to the body's left, y up), 1.7 tall
JOINTS = np.array([
    [0.0, -0.05, 0.0],  # 0 pelvis
    [0.09, -0.12, 0.0], [-0.09, -0.12, 0.0],  # 1-2 hips
    [0.0, 0.07, 0.0],  # 3 spine1
    [0.09, -0.46, 0.01], [-0.09, -0.46, 0.01],  # 4-5 knees
    [0.0, 0.2, 0.0],  # 6 spine2
    [0.09, -0.78, -0.01], [-0.09, -0.78, -0.01],  # 7-8 ankles
    [0.0, 0.3, 0.0],  # 9 spine3
    [0.09, -0.82, 0.05], [-0.09, -0.82, 0.05],  # 10-11 feet
    [0.0, 0.55, 0.0],  # 12 neck
    [0.06, 0.48, 0.0], [-0.06, 0.48, 0.0],  # 13-14 collars
    [0.0, 0.7, 0.0],  # 15 head
    [0.16, 0.47, 0.0], [-0.16, 0.47, 0.0],  # 16-17 shoulders
    [0.19, 0.22, 0.0], [-0.19, 0.22, 0.0],  # 18-19 elbows
    [0.2, 0.0, 0.02], [-0.2, 0.0, 0.02],  # 20-21 wrists
    [0.2, -0.08, 0.02], [-0.2, -0.08, 0.02],  # 22-23 hands
], np.float64)
# half-width and half-depth of the body's cross-section by height
PROFILE_Y = np.array([-0.85, -0.8, -0.6, -0.46, -0.3, -0.12, 0.0, 0.12, 0.3, 0.45, 0.5, 0.55,
                      0.6, 0.7, 0.8, 0.85])
PROFILE_W = np.array([0.1, 0.12, 0.12, 0.13, 0.16, 0.19, 0.16, 0.15, 0.18, 0.22, 0.21, 0.07,
                      0.06, 0.09, 0.08, 0.06])
PROFILE_D = np.array([0.08, 0.09, 0.07, 0.07, 0.09, 0.11, 0.1, 0.1, 0.12, 0.11, 0.09, 0.06,
                      0.06, 0.1, 0.09, 0.06])


def _zigzag(ring):
    """Triangles closing a ring of vertex ids without an inner vertex."""
    lo, hi, out, left = 0, len(ring) - 1, [], True
    while hi - lo > 1:
        if left:
            out.append([ring[lo], ring[lo + 1], ring[hi]])
            lo += 1
        else:
            out.append([ring[lo], ring[hi - 1], ring[hi]])
            hi -= 1
        left = not left
    return out


def mesh():
    """(verts [6890, 3] f64, faces [13776, 3] int64) of the closed body
    surface, rings from the top down, faces wound outwards."""
    theta = np.pi * (np.arange(RINGS) + 0.5) / RINGS
    phi = 2.0 * np.pi * np.arange(SEGMENTS) / SEGMENTS
    y = 0.5 * HEIGHT * np.cos(theta)
    hw = np.interp(y, PROFILE_Y, PROFILE_W) * np.sqrt(np.sin(theta))
    hd = np.interp(y, PROFILE_Y, PROFILE_D) * np.sqrt(np.sin(theta))
    verts = np.stack([hw[:, None] * np.cos(phi)[None], np.broadcast_to(y[:, None], (RINGS, SEGMENTS)),
                      hd[:, None] * np.sin(phi)[None]], -1).reshape(-1, 3)
    idx = lambda r, s: r * SEGMENTS + s % SEGMENTS
    faces = []
    for r in range(RINGS - 1):
        for s in range(SEGMENTS):
            a, b, c, d = idx(r, s), idx(r, s + 1), idx(r + 1, s), idx(r + 1, s + 1)
            faces += [[a, b, d], [a, d, c]]
    top = [idx(0, s) for s in range(SEGMENTS)]
    bottom = [idx(RINGS - 1, s) for s in range(SEGMENTS)]
    faces += [f[::-1] for f in _zigzag(top)] + _zigzag(bottom)
    faces = np.asarray(faces, np.int64)
    assert verts.shape[0] == NUM_VERTS and faces.shape[0] == NUM_FACES
    return verts, faces


def model():
    """{"v_template" [V, 3], "shapedirs" [V, 3, 10], "J_regressor" [24, V],
    "lbs_weights" [V, 24] (f32), "parents" (24,), "faces" [F, 3] int64}."""
    verts, faces = mesh()
    # joint regressor: a band around the joint's height, weighted to its side
    band = np.exp(-0.5 * ((verts[None, :, 1] - JOINTS[:, None, 1]) / 0.03) ** 2)
    side = np.exp(-0.5 * ((verts[None, :, 0] - JOINTS[:, None, 0]) / 0.08) ** 2)
    j_reg = band * side
    j_reg = np.where(j_reg >= 1e-3 * j_reg.max(axis=1, keepdims=True), j_reg, 0.0)
    j_reg /= j_reg.sum(axis=1, keepdims=True)
    # skin weights: the four nearest joints, falling off with distance
    d2 = ((verts[:, None, :] - JOINTS[None]) ** 2).sum(-1)
    w = np.exp(-0.5 * d2 / 0.1**2)
    keep = np.argsort(d2, axis=1)[:, :4]
    mask = np.zeros_like(w, bool)
    np.put_along_axis(mask, keep, True, axis=1)
    w = np.where(mask, w, 0.0) + np.where(mask, 1e-12, 0.0)
    w /= w.sum(axis=1, keepdims=True)
    # shape directions: smooth fields over the body, the same every run
    rng = np.random.default_rng(20150101)
    basis = rng.normal(size=(NUM_BETAS, 3, 3)) * 0.02
    shapedirs = np.einsum("vi,kji->vjk", verts, basis)
    f32 = lambda a: np.asarray(a, np.float32)
    return {"v_template": f32(verts), "shapedirs": f32(shapedirs), "J_regressor": f32(j_reg),
            "lbs_weights": f32(w), "parents": PARENTS, "faces": faces}

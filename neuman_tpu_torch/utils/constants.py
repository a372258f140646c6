"""Constants the port reads (the values of neuman_tpu/utils/constants.py)."""

# the 32x32 LPIPS patch of the human stage's sampler
PATCH_SIZE = 32
PATCH_SIZE_SQUARED = PATCH_SIZE**2
DEFAULT_GEO_THRESH = 0.2
# stratified-sample jitter is clipped to [eps, 1 - eps]
PERTURB_EPSILON = 0.01
# -log(exp(-0) + exp(-1)): the hard-surface prior's value at a weight of 0 or 1
HARD_SURFACE_OFFSET = 0.31326165795326233
# the canonical 360-degree cameras of the human stage
CANONICAL_ZOOM_FACTOR = 1000 / 1280
CANONICAL_CAMERA_DIST = 3.0

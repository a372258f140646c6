"""Constants the port reads (the values of neuman_tpu/utils/constants.py)."""

# the 32x32 LPIPS patch of the human stage's sampler
PATCH_SIZE = 32
PATCH_SIZE_SQUARED = PATCH_SIZE**2
DEFAULT_GEO_THRESH = 0.2
# stratified-sample jitter is clipped to [eps, 1 - eps]
PERTURB_EPSILON = 0.01

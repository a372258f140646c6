"""Geometry-guided near and far: the `hit_test` CUDA kernel.

Each ray's near and far over the spheres of radius geo_threshold about
the body's vertices (ops/rays.py `geometry_guided_near_far`): the least
z0 - dz and the greatest z0 + dz over the spheres the ray passes through,
near = +inf and far = -inf where it passes through none. The kernel holds
each ray's running near and far in registers and the vertices in shared
memory, so no [rays, V] tensor reaches device memory; every ray meets
every vertex. It computes each test from p = v - o (h^2 = |p - z0 d|^2 +
z0^2 (1 - |d|^2), the plain version's |p|^2 - z0^2 without its
cancellation), so its near and far are closer to an f64 computation than
the plain version's. Source:
neuman_tpu_torch/csrc/hit_test.cu, whose header says what bounds it on the
H100 and how the design answers that.

There is no TPU kernel behind it (the JAX function is plain jnp): its plain
twin is `ops/rays.geometry_guided_near_far_plain`, which runs for CPU
tensors. `hit_test` launches the kernel for CUDA tensors (or raises).
`hit_plan` is the launch plan (ray tiles x vertex slices), computed here.
"""

import ctypes
import functools

import torch

from neuman_tpu_torch.ops.kernels import _build
from neuman_tpu_torch.utils import tracing

# the kernel's layout (csrc/hit_test.cu): 128 threads of 4 rays a block
HIT_THREADS = 128
HIT_RAYS_PER_THREAD = 4
HIT_TILE = HIT_THREADS * HIT_RAYS_PER_THREAD
# V / MIN_SLICE_VERTS bounds the slices; the split aims at BLOCKS_PER_SM
MIN_SLICE_VERTS = 64
BLOCKS_PER_SM = 8


def hit_plan(num_rays, num_verts, num_sms):
    """The kernel's launch plan for R rays against V vertices on a card with
    `num_sms` SMs: a dict of

    - tiles: blocks along the rays, one a tile of HIT_TILE rays;
    - slices: blocks along the vertices, so that tiles x slices reaches
      BLOCKS_PER_SM blocks an SM where the rays alone do not, but no more
      than V / MIN_SLICE_VERTS rounded up, and none empty; with more than
      one, a second kernel combines the slices' partial near and far;
    - slice_verts: vertices a slice (the last may hold fewer)."""
    tiles = -(-num_rays // HIT_TILE)
    want = -(-BLOCKS_PER_SM * num_sms // max(tiles, 1))
    slices = max(1, min(-(-num_verts // MIN_SLICE_VERTS), want))
    slice_verts = max(1, -(-num_verts // slices))
    slices = max(1, -(-num_verts // slice_verts))
    return {"tiles": tiles, "slices": slices, "slice_verts": slice_verts}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("hit_test")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hit_test_launch.argtypes = [p] * 7 + [i] * 6 + [ctypes.c_float, p]
    lib.hit_test_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _num_sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def hit_test(origin, direction, verts, geo_threshold):
    """(near [R], far [R]) f32 of rays origin, direction [R, 3] against the
    spheres of radius geo_threshold (a number) about verts [V, 3], all f32
    CUDA tensors on one device: the kernel's launch. The rays' rows may lie
    any stride apart (an origin expanded to every ray is read in place). No
    gradient flows."""
    device = origin.device
    for t, what in ((origin, "origin"), (direction, "direction"), (verts, "verts")):
        if t.device != device or t.dtype != torch.float32 or t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"hit_test: {what} must be f32 [N, 3] on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if direction.shape[0] != origin.shape[0]:
        raise ValueError(f"hit_test: {origin.shape[0]} origins but {direction.shape[0]} "
                         "directions")
    origin, direction = (t if t.stride(1) == 1 else t.contiguous() for t in (origin, direction))
    verts = verts.contiguous()
    r, v = origin.shape[0], verts.shape[0]
    plan = hit_plan(r, v, _num_sms(device.index or 0))
    # near and far, then the slices' partial near and far rows, which the
    # combine kernel reads; addressed by offsets (few tensor ops a call: the
    # renders call once a 2,048-ray chunk)
    slices = plan["slices"]
    out = torch.empty(2, r, device=device)
    if not r:
        return out.unbind(0)
    row = r * out.element_size()
    part = torch.empty(2, slices, r, device=device) if slices > 1 else None
    near_part = None if part is None else part.data_ptr()
    far_part = None if part is None else near_part + slices * row
    err = _lib().hit_test_launch(
        origin.data_ptr(), direction.data_ptr(), verts.data_ptr(), out.data_ptr(),
        out.data_ptr() + row, near_part, far_part, r, origin.stride(0), direction.stride(0), v,
        slices, plan["slice_verts"], float(geo_threshold) ** 2,
        torch.cuda.current_stream(device).cuda_stream)
    if err == -1:
        raise ValueError(f"hit_test kernel: bad plan {plan} for V={v}")
    _build.check(err, "hit_test")
    tracing.count("launches.hit_test")
    return out.unbind(0)

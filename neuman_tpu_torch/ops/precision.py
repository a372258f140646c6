"""Float32 matrix products that stay float32 on the card."""

import contextlib

import torch


def matmul_f32(a, b):
    """a @ b with TF32 turned off: ray directions and the ray/vertex
    near-far products lose hits at TF32's ~3 digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return a @ b


@contextlib.contextmanager
def no_tf32():
    """TF32 off for the matrix products inside the scope (forward and
    backward alike); the caller's flag comes back on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved

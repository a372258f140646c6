"""The plain reference every cell's `correct` is decided by.

Plain PyTorch, float32 with TF32 off, no kernel, no cache: NeuMan's
networks, volume rendering, ray sampling, body warp, losses and Adam, as
the published descriptions (NeRF, arXiv:2003.08934; NeuMan,
arXiv:2203.12575) and the port's plain code paths at the time the
benchmark was written compute them. It imports nothing of the program and
nothing of the JAX package: where it follows the program's own choices (the
group KNN, the Ericson region order, the draw order of a step), it holds a
frozen copy of them here.

`Precision` says in what the reference computes: "float32" is the
reference; the lower ones ("tf32", "fp8") are the controls that have to
come out as not correct.
"""

import contextlib

import torch


def tf32(t):
    """f32 values rounded to TF32's 10 mantissa bits (to nearest, ties to
    even), as the tensor cores take their operands."""
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _RoundedMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd):
        ra, rb = rnd(a), rnd(b)
        ctx.save_for_backward(ra, rb)
        ctx.rnd = rnd
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        g = ctx.rnd(g)
        return g @ rb.T, ra.T @ g, None


class Precision:
    """How the reference's matrix products round. "float32": exact f32
    (TF32 off); "tf32": both operands of every product of the networks
    rounded to TF32, f32 accumulation (what TF32 tensor cores compute, on
    any device), convolutions with cuDNN's TF32; "fp8": both operands
    rounded to float8 e4m3, f32 accumulation."""

    NAMES = ("float32", "tf32", "fp8")

    def __init__(self, name="float32"):
        if name not in self.NAMES:
            raise ValueError(f"precision must be one of {self.NAMES}, not {name!r}")
        self.name = name

    def rnd(self, t):
        if self.name == "fp8":
            return t.to(torch.float8_e4m3fn).float()
        if self.name == "tf32":
            return tf32(t)
        return t

    def mm(self, a, b):
        """a @ b of the networks' layers, in this precision: the operands
        rounded in the forward and in the backward's products alike."""
        if self.name == "float32":
            return a @ b
        return _RoundedMM.apply(a, b, self.rnd)

    @contextlib.contextmanager
    def scope(self):
        """TF32 off for the matrix products (the networks' are rounded by
        `mm`), on for cuDNN's convolutions under "tf32"; the flags come back
        on exit."""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = self.name == "tf32"
        try:
            yield self
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


F32 = Precision("float32")

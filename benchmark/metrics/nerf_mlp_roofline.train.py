"""`nerf_mlp_roofline.train`: the NeRF MLP kernels' share of their roofline in
a step (benchmark/readers.py `roofline`; the kernels in `readers.NERF_MLP`
and the shared dW passes that follow a NeRF chain pass)."""

from benchmark import readers


def read(ctx):
    return readers.roofline(ctx, "step")

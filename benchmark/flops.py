"""The yardstick's arithmetic: the published H100 peaks and the work of the
NeRF and offset MLPs, counted from the configuration's widths and a
step's or frame's sample counts, never from a kernel.

A forward counts its multiply-adds once and a backward twice (dX and dW),
whatever the backward does to get there: the port's `chip_smoke.mlp_bound`
counts a recompute backward as 3x the forward and a tape backward as 2x,
so its "work" changes with the implementation (`mlp_tape`), and a faster
backward could read as a lower share. Here the work is the model's, and a
kernel that recomputes pays for it in its time. Bytes count each input
once and each output once.
"""

# NVIDIA H100 SXM data sheet, dense: f32 outside the tensor cores, bf16 on them; HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def mlp_macs(width, depth, skips, in_ch, views_ch=0, out_ch=4):
    """(multiply-adds a sample, multiply-adds of the direction term) of a
    NeRF MLP: the trunk of `depth` layers with the encoding concatenated
    after each layer in `skips`, then the view head (density, feature,
    the direction layer, rgb) or one output layer. The direction term is
    views_ch x width/2: once a ray where the direction is the ray's, once a
    sample where it is the sample's."""
    trunk, fan = 0, in_ch
    for i in range(depth):
        trunk += fan * width
        fan = width + in_ch if i in skips else width
    if not views_ch:
        return trunk + width * out_ch, 0
    half = width // 2
    return trunk + width + width * width + width * half + half * 3, views_ch * half


def mlp_params(width, depth, skips, in_ch, views_ch=0, out_ch=4):
    ps, dirs = mlp_macs(width, depth, skips, in_ch, views_ch, out_ch)
    biases = depth * width + ((1 + width + width // 2 + 3) if views_ch else out_ch)
    return ps + dirs + biases


def mlp_work(macs, params, samples, rays, per_sample_dirs, trained, planes_in=3, outs=4):
    """(flops, bytes) of one application of an MLP over `samples` points of
    `rays` rays: forward 2 x MACs, backward twice that when `trained`."""
    per_sample, dirs = macs
    mac = samples * per_sample + (samples if per_sample_dirs else rays) * dirs
    flops = 2 * mac * (3 if trained else 1)
    dir_in = (samples if per_sample_dirs else rays) * 12 if dirs else 0
    fwd = samples * 4 * planes_in + dir_in + params * 4 + samples * 4 * outs
    bwd = samples * 4 * planes_in + samples * 4 * outs + params * 8 if trained else 0
    return flops, fwd + bwd


def roofline_s(flops, nbytes, dtype):
    """The least time the chip could take: the larger of operations over
    the peak and bytes over the bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)

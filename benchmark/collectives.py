"""The yardstick's arithmetic of a data-parallel step's collectives: the
bytes its all-reduces carry, counted from the configuration's widths and
never from the program's counters (so a share reads the same work however
the program packs its reductions), and the published NVLink bandwidth of
the H100 SXM.

A ring all-reduce of N bytes over n ranks moves 2(n-1)/n x N bytes in and
out of each rank (NCCL's "bus bytes"); its least time is that over the
link's bandwidth each way.
"""

# NVIDIA H100 SXM data sheet: NVLink 4, 900 GB/s a GPU in both directions together
NVLINK_BYTES_PER_S = 450e9
F32_BYTES = 4
# a stage-1 step's losses that the ranks sum (coarse and fine RGB and
# empty-space losses, their two sums and the total), its two density maxima
# and its two penalty-mask counts
BKG_LOSSES, BKG_MAXIMA, BKG_MASK_COUNTS = 7, 2, 2


def bkg_step_bytes(params_per_net):
    """Bytes that the ranks of one stage-1 step reduce, all f32: the
    gradients of the coarse and the fine net, the losses, the maxima and
    the mask counts."""
    return F32_BYTES * (2 * params_per_net + BKG_LOSSES + BKG_MAXIMA + BKG_MASK_COUNTS)


def bus_bytes(nbytes, ranks):
    """Bytes in and out of each rank of a ring all-reduce of `nbytes`."""
    return 2.0 * (ranks - 1) / ranks * nbytes


def least_s(bus):
    """The least time of `bus` bus bytes at the published NVLink bandwidth."""
    return bus / NVLINK_BYTES_PER_S

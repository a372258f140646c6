"""The hand-written CUDA kernels and their wrappers."""

from neuman_tpu_torch.utils import tracing

# each wrapper counts its kernel's launches (not the calls that run its
# plain version) as the counter `launches.<kernel>` of utils/tracing.py
KERNELS = ("nerf_mlp", "nerf_mlp_bwd", "offset_mlp", "offset_mlp_bwd", "ericson_select",
           "ericson_signed_select", "bucketed_knn", "hit_test", "exact_knn")


def launches(since=None):
    """{kernel name: its launches in this process}, less `since` (an
    earlier reading) where given."""
    now = {k: tracing.total("launches." + k) for k in KERNELS}
    return now if since is None else {k: v - since[k] for k, v in now.items()}

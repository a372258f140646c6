"""The hand-written CUDA kernels and their wrappers."""


def wrappers():
    """{kernel name: its wrapper}; a wrapper's `launches` counts the
    launches of its kernel (not the calls that run its plain version)."""
    from neuman_tpu_torch.ops.kernels import knn, meshquery, nerf_mlp, nerf_mlp_vjp, offset_mlp

    return {"nerf_mlp": nerf_mlp.nerf_mlp, "nerf_mlp_bwd": nerf_mlp_vjp.nerf_mlp_bwd,
            "offset_mlp": offset_mlp.offset_mlp, "offset_mlp_bwd": offset_mlp.offset_mlp_bwd,
            "ericson_select": meshquery.ericson_select,
            "ericson_signed_select": meshquery.ericson_signed_select,
            "bucketed_knn": knn.bucketed_knn}

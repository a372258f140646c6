"""Weights across packages: neuman_tpu param pytrees <-> torch state_dicts.

The JAX package stores a linear layer as {"w": [in, out], "b": [out]}
(forward x @ w); torch stores weight [out, in]. `from_jax_params` is the
inverse of `neuman_tpu.trainers.checkpoint.convert_hybrid_state_dict`, so
the keys it writes are the reference checkpoint's keys; `to_jax_params` is
the inverse of `joiner_state_dict`.
"""

import re

import numpy as np
import torch

_HEADS = ("feature_linear", "alpha_linear", "rgb_linear", "output_linear")


def joiner_state_dict(params):
    """One NeRF's params (numpy leaves) -> state_dict of a Joiner (keys
    `nerf.pts_linears.{i}.weight`, ...)."""
    sd = {}

    def linear(prefix, p):
        sd[f"nerf.{prefix}.weight"] = torch.tensor(np.asarray(p["w"], np.float32).T)
        sd[f"nerf.{prefix}.bias"] = torch.tensor(np.asarray(p["b"], np.float32))

    for i, p in enumerate(params["pts_linears"]):
        linear(f"pts_linears.{i}", p)
    for i, p in enumerate(params.get("views_linears", [])):
        linear(f"views_linears.{i}", p)
    for name in _HEADS:
        if name in params:
            linear(name, params[name])
    return sd


def from_jax_params(params_np):
    """HumanNeRF param pytree (numpy leaves) -> HumanNeRF state_dict.

    Only the networks are converted; the per-frame SMPL entries (`poses`,
    `betas`, `alignments`) are not part of the module and are skipped.
    """
    nets = {name: params_np[name]
            for name in ("coarse_bkg_net", "fine_bkg_net", "coarse_human_net")}
    for i, p in enumerate(params_np.get("offset_nets", [])):
        nets[f"offset_nets.{i}"] = p
    return {f"{prefix}.{k}": v for prefix, p in nets.items()
            for k, v in joiner_state_dict(p).items()}


def to_jax_params(state_dict):
    """Joiner state_dict (keys `nerf.pts_linears.{i}.weight`, ...; tensors
    or arrays) -> one NeRF's param tree with numpy leaves; a dict
    {"coarse": sd, "fine": sd} converts each net."""
    if set(state_dict) == {"coarse", "fine"}:
        return {k: to_jax_params(sd) for k, sd in state_dict.items()}
    numpy = lambda v: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v)).astype(np.float32)
    params = {}
    for key, value in state_dict.items():
        m = re.fullmatch(r"nerf\.(\w+?)(?:\.(\d+))?\.(weight|bias)", key)
        if m is None:
            raise KeyError(f"not a NeRF parameter: {key}")
        name, index, kind = m.groups()
        leaf = numpy(value).T.copy() if kind == "weight" else numpy(value)
        slot = params.setdefault(name, [] if index is not None else {})
        if index is not None:
            while len(slot) <= int(index):
                slot.append({})
            slot = slot[int(index)]
        slot["w" if kind == "weight" else "b"] = leaf
    return params

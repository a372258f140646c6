"""Weights across packages: neuman_tpu param pytrees <-> torch state_dicts.

The JAX package stores a linear layer as {"w": [in, out], "b": [out]}
(forward x @ w); torch stores weight [out, in]. `from_jax_params` is the
inverse of `neuman_tpu.trainers.checkpoint.convert_hybrid_state_dict`, so
the keys it writes are the reference checkpoint's keys; `to_jax_params` is
the inverse of `joiner_state_dict` and of `from_jax_params`.
"""

import re

import numpy as np
import torch

from neuman_tpu_torch.trainers.checkpoint import safe_merge_params

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


_SMPL_STATE = ("poses", "betas", "alignments")
_HYBRID_NETS = ("coarse_bkg_net", "fine_bkg_net", "coarse_human_net")


def from_jax_params(params_np):
    """HumanNeRF param pytree (numpy leaves) -> HumanNeRF state_dict: the
    three joiners, the offset nets and, where the tree has them, the
    per-frame SMPL entries `poses`, `betas`, `alignments`."""
    nets = {name: params_np[name] for name in _HYBRID_NETS}
    for i, p in enumerate(params_np.get("offset_nets", [])):
        nets[f"offset_nets.{i}"] = p
    sd = {f"{prefix}.{k}": v for prefix, p in nets.items()
          for k, v in joiner_state_dict(p).items()}
    for name in _SMPL_STATE:
        if name in params_np:
            sd[name] = torch.tensor(np.asarray(params_np[name], np.float32))
    return sd


def to_jax_params(state_dict):
    """Joiner state_dict (keys `nerf.pts_linears.{i}.weight`, ...; tensors
    or arrays) -> one NeRF's param tree with numpy leaves; a dict
    {"coarse": sd, "fine": sd} converts each net; a HumanNeRF state_dict
    gives the JAX package's hybrid tree (the inverse of `from_jax_params`)."""
    if set(state_dict) == {"coarse", "fine"}:
        return {k: to_jax_params(sd) for k, sd in state_dict.items()}
    numpy = lambda v: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v)).astype(np.float32)
    if any(k.startswith("coarse_human_net.") for k in state_dict):
        sub = lambda prefix: {k[len(prefix):]: v for k, v in state_dict.items()
                              if k.startswith(prefix)}
        params = {name: to_jax_params(sub(f"{name}.")) for name in _HYBRID_NETS}
        n_off = len({k.split(".")[1] for k in state_dict if k.startswith("offset_nets.")})
        params["offset_nets"] = [to_jax_params(sub(f"offset_nets.{i}.")) for i in range(n_off)]
        params.update({name: numpy(state_dict[name]) for name in _SMPL_STATE
                       if name in state_dict})
        return params
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


def load_hybrid(model, tree):
    """The leaves of a checkpoint's "hybrid_model" tree (of either package)
    into the HumanNeRF `model`, where path and shape match: the merge of
    `trainers.checkpoint.safe_merge_params`. Returns the paths that kept
    the model's own values."""
    merged, missing = safe_merge_params(to_jax_params(model.state_dict()), tree)
    model.load_state_dict(from_jax_params(merged))
    return missing

"""LPIPS perceptual distance, AlexNet variant (counterpart of
neuman_tpu/models/lpips.py).

Input in [-1, 1] -> fixed shift and scale -> the five AlexNet convolutions;
the features after each ReLU are unit-normalised over channels; squared
differences go through the learned 1x1 "lin" weights (clamped at 0), a
spatial mean, and a sum over the five layers. The convolutions and the
pooling are library calls (torch.nn.functional), as they are XLA
convolutions in the JAX package. Weights come from a seed here (the
calibrated ones need a download); a loss on them is a valid perceptual
distance with the cost of the calibrated one.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

# (out_ch, in_ch, kernel, stride, pad) of the five convolutions
_ALEX_CONVS = [
    (64, 3, 11, 4, 2),
    (192, 64, 5, 1, 2),
    (384, 192, 3, 1, 1),
    (256, 384, 3, 1, 1),
    (256, 256, 3, 1, 1),
]
# max pool (3x3, stride 2) after the first two ReLUs
_POOL_AFTER = {0, 1}
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def init_lpips_params(seed, device=None):
    """{"convs": [{"w" [O, I, k, k], "b" [O]}], "lins": [[O]]} drawn on the
    host from `seed`: conv weights U(+-1/sqrt(fan_in)), zero biases, lin
    weights U(0, 0.1), as the JAX package initialises them."""
    gen = torch.Generator().manual_seed(seed)
    params = {"convs": [], "lins": []}
    for oc, ic, k, _, _ in _ALEX_CONVS:
        bound = 1.0 / math.sqrt(ic * k * k)
        w = torch.empty(oc, ic, k, k).uniform_(-bound, bound, generator=gen)
        params["convs"].append({"w": w.to(device), "b": torch.zeros(oc, device=device)})
        params["lins"].append(torch.empty(oc).uniform_(0, 0.1, generator=gen).to(device))
    return params


def lpips_params_from_jax(params_np, device=None):
    """The JAX package's LPIPS param tree (numpy leaves) as tensors."""
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
    return {"convs": [{"w": as_t(c["w"]), "b": as_t(c["b"])} for c in params_np["convs"]],
            "lins": [as_t(l) for l in params_np["lins"]]}


def _features(params, x):
    feats = []
    for i, (_, _, _, stride, pad) in enumerate(_ALEX_CONVS):
        conv = params["convs"][i]
        x = torch.relu(F.conv2d(x, conv["w"], conv["b"], stride=stride, padding=pad))
        feats.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 3, 2)
    return feats


def _unit_normalize(f, eps=1e-10):
    return f / (torch.sqrt((f * f).sum(dim=1, keepdim=True)) + eps)


def cudnn_scope(**flags):
    """`torch.backends.cudnn.flags` with the given flags and the caller's
    others: a scope that restores every flag on exit. ATen reads the flags
    when a convolution (or its backward) runs, so a scope that should cover
    a backward encloses the `backward` / `autograd.grad` call too."""
    cudnn = torch.backends.cudnn
    now = dict(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
               deterministic=cudnn.deterministic, allow_tf32=cudnn.allow_tf32)
    return cudnn.flags(**{**now, **flags})


def lpips(params, img0, img1):
    """Perceptual distance [B] between images in [-1, 1], NCHW. f32
    convolutions run in full f32 (TF32 off, in a scope), as the f32
    matmuls do; the train step's scope (`cudnn_scope` in
    trainers/human.py) also keeps TF32 off for their backward."""
    with cudnn_scope(allow_tf32=False):
        return _lpips(params, img0, img1)


def _lpips(params, img0, img1):
    shift = torch.tensor(_SHIFT, device=img0.device)[None, :, None, None]
    scale = torch.tensor(_SCALE, device=img0.device)[None, :, None, None]
    f0 = _features(params, (img0 - shift) / scale)
    f1 = _features(params, (img1 - shift) / scale)
    total = 0.0
    for a, b, lin in zip(f0, f1, params["lins"]):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
        total = total + (d * lin.clamp(min=0.0)[None, :, None, None]).sum(dim=1).mean(dim=(1, 2))
    return total

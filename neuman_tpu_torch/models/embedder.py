"""Positional encodings (counterpart of neuman_tpu/models/embedder.py).

- 'posenc': rows [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...] with
  f = 2**linspace(min_freq, max_freq, n_freqs); the exponents are rounded
  to f32 first, exactly as the JAX package does.
- 'rotate': rows [x, sin(x B^T) all, cos(x B^T) all], B the axis-aligned
  frequency basis turned by two fixed 45-degree rotations.

sin/cos are always evaluated directly (the JAX package's double-angle
recurrence is a TPU cost-model trick and is not ported).
"""

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class EmbedderSpec:
    mapping: str
    input_dims: int
    include_input: bool
    out_dim: int
    freq_bands: tuple = ()  # 'posenc': [n_freqs]
    bvals: tuple = ()  # 'rotate': [n_freqs*3, 3] flattened row-major

    def bvals_tensor(self, device=None):
        return torch.tensor(self.bvals, dtype=torch.float32, device=device).reshape(-1, 3)


def make_embedder(input_dims, max_freq, n_freqs, log_sampling=True,
                  include_input=True, min_freq=0, mapping="posenc"):
    if not log_sampling:
        raise ValueError("linear frequency sampling is unsupported")
    if mapping == "posenc":
        exps = np.linspace(min_freq, max_freq, num=n_freqs).astype(np.float32)
        freqs = (2.0 ** exps.astype(np.float64)).astype(np.float32)
        out_dim = (input_dims if include_input else 0) + 2 * n_freqs * input_dims
        return EmbedderSpec("posenc", input_dims, include_input, out_dim,
                            freq_bands=tuple(float(f) for f in freqs))
    if mapping == "rotate":
        if input_dims != 3:
            raise ValueError("the 'rotate' mapping takes 3-D input")
        bvals = 2.0 ** np.linspace(min_freq, max_freq, num=n_freqs)
        bvals = np.reshape(np.eye(3) * bvals[:, None, None], [n_freqs * 3, 3])
        s = (2**0.5) / 2
        rot1 = np.array([[s, -s, 0], [s, s, 0], [0, 0, 1]])
        rot2 = np.array([[1, 0, 0], [0, s, -s], [0, s, s]])
        bvals = bvals @ rot1.T @ rot2.T
        out_dim = n_freqs * 2 * 3 + (3 if include_input else 0)
        return EmbedderSpec("rotate", input_dims, include_input, out_dim,
                            bvals=tuple(float(v) for v in bvals.reshape(-1)))
    raise ValueError(mapping)


def rotate_projection(x, bv):
    """x [..., 3] . bv [F, 3]^T -> [..., F] f32, as the fused multiply-add
    chain fma(x2, b2, fma(x1, b1, x0 b0)): what a CPU matmul (torch's and
    XLA's alike) computes for this product, and what the CUDA kernels
    compute with explicit FMAs. Each FMA is taken exactly in f64 and
    rounded once to f32. At the top band |x . b| reaches ~10^3, where one
    ulp of a differently rounded projection moves sin and cos by ~1e-4 and
    flips ReLU masks downstream, so the kernels and the plain versions
    must project alike."""
    f64 = lambda t: t.double()
    acc = x[..., 0:1] * bv[:, 0]
    for a in (1, 2):
        acc = (f64(x[..., a:a + 1]) * f64(bv[:, a]) + f64(acc)).to(x.dtype)
    return acc


def embed(spec: EmbedderSpec, x):
    """x: [..., input_dims] -> [..., out_dim]."""
    if x.shape[-1] != spec.input_dims:
        raise ValueError(f"expected {spec.input_dims} input dims, got {tuple(x.shape)}")
    if spec.mapping == "posenc":
        parts = [x] if spec.include_input else []
        for f in spec.freq_bands:
            parts += [torch.sin(x * f), torch.cos(x * f)]
        return torch.cat(parts, dim=-1)
    proj = rotate_projection(x, spec.bvals_tensor(x.device).to(x.dtype))
    parts = [x] if spec.include_input else []
    return torch.cat(parts + [torch.sin(proj), torch.cos(proj)], dim=-1)

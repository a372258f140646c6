"""Image resizing as Pillow's `Image.resize` does it, in numpy: the scene
reader's `tgt_size` path (images BILINEAR; masks and depth maps NEAREST),
the same pixels as the JAX package's PIL calls give.

- "bilinear" on uint8 [H, W] or [H, W, C]: Pillow's two separable passes,
  horizontal then vertical. Each output pixel convolves a triangle filter
  whose support grows with the shrink factor (so shrinking averages, it
  does not skip), with fixed-point coefficients of 22 fractional bits; each
  pass rounds and clips to uint8.
- "nearest" on any [H, W] or [H, W, C] array: Pillow's affine scaling, the
  source index of output x the floor of a running sum of (W_in / W_out)
  that starts at half a step.
"""

import math

import numpy as np

_PRECISION_BITS = 32 - 8 - 2


def _bilinear_coeffs(in_size, out_size):
    """(first source index [out], fixed-point weights [out, K]) of one
    axis: Pillow's precompute_coeffs and normalize_coeffs_8bpc for the
    triangle filter of support 1."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax, dtype=np.float64)
        k = np.maximum(1.0 - np.abs((x + xmin - center + 0.5) * (1.0 / filterscale)), 0.0)
        ww = 0.0
        for v in k:  # summed in order, as the C loop sums
            ww += v
        if ww != 0.0:
            k = k / ww
        # truncation toward zero of w * 2^22 +- 0.5 (the weights are >= 0)
        weights[xx, :xmax] = np.trunc(0.5 + k * (1 << _PRECISION_BITS)).astype(np.int64)
        first[xx] = xmin
    return first, weights


def _bilinear_pass(img, out_size, axis):
    """One 8-bit pass along `axis` of a uint8 array: the weighted sum with
    a rounding half added, shifted down and clipped to [0, 255]."""
    first, weights = _bilinear_coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    extra = (1,) * (src.ndim - 1)
    for j in range(weights.shape[1]):
        idx = np.minimum(first + j, src.shape[0] - 1)  # weight 0 past the end
        acc += src[idx] * weights[:, j].reshape((-1,) + extra)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _nearest_index(in_size, out_size):
    step = float(np.float32(in_size)) / out_size
    pos = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
    idx = np.where(pos < 0.0, -1, pos.astype(np.int64))
    if (idx < 0).any() or (idx >= in_size).any():
        raise ValueError("nearest resize index out of range")
    return idx


def resize(img, tgt_size, sampling):
    """`img` resized to `tgt_size` (H, W) by `sampling` ("bilinear" or
    "nearest"), as Pillow's Image.resize((W, H), ...) on the same array."""
    img = np.asarray(img)
    h, w = int(tgt_size[0]), int(tgt_size[1])
    if img.ndim not in (2, 3):
        raise ValueError(f"resize takes [H, W] or [H, W, C], not {img.shape}")
    if img.shape[:2] == (h, w):
        return img.copy()
    if sampling == "nearest":
        return img[_nearest_index(img.shape[0], h)][:, _nearest_index(img.shape[1], w)]
    if sampling != "bilinear":
        raise ValueError(f"unknown sampling {sampling!r}")
    if img.dtype != np.uint8 or (img.ndim == 3 and img.shape[2] not in (1, 3)):
        raise ValueError(f"bilinear resize takes uint8 grayscale or RGB, not {img.dtype} "
                         f"{img.shape}")
    if img.shape[1] != w:
        img = _bilinear_pass(img, w, 1)
    if img.shape[0] != h:
        img = _bilinear_pass(img, h, 0)
    return img

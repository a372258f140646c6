"""Evaluation metrics: PSNR, SSIM, LPIPS (the port's copy of
neuman_tpu/utils/metrics.py).

PSNR and SSIM are float64 numpy/scipy on the host, as skimage's
peak_signal_noise_ratio and structural_similarity(multichannel=True) with
their defaults compute them: a 7x7 uniform window (scipy's uniform_filter,
its default "reflect" boundary), sample covariance, K1=0.01, K2=0.03, the
data range from the first image's dtype, the window's half-width cropped
from the border before the mean, the channels averaged. LPIPS is the
port's AlexNet LPIPS (models/lpips.py) on the device its weights are on.
"""

import numpy as np
import torch
from scipy import ndimage

from neuman_tpu_torch.models import lpips as lpips_module


def psnr(gt, pred, data_range=None):
    gt = np.asarray(gt, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    if data_range is None:
        data_range = 255.0
    mse = np.mean((gt - pred) ** 2)
    if mse == 0:
        return np.inf
    return 10.0 * np.log10((data_range**2) / mse)


def _ssim_single(x, y, data_range, win_size=7, k1=0.01, k2=0.03):
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    nper = win_size**x.ndim
    cov_norm = nper / (nper - 1)

    filt = lambda a: ndimage.uniform_filter(a, size=win_size)
    ux = filt(x)
    uy = filt(y)
    uxx = filt(x * x)
    uyy = filt(y * y)
    uxy = filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux**2 + uy**2 + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    pad = (win_size - 1) // 2
    crop = tuple(slice(pad, dim - pad) for dim in s.shape)
    return s[crop].mean()


def ssim(gt, pred, data_range=None, multichannel=True, win_size=7):
    """SSIM of two images; `data_range` defaults to 255 when `gt` (the
    first argument) is uint8, else 1."""
    gt = np.asarray(gt)
    pred = np.asarray(pred)
    if data_range is None:
        data_range = 255.0 if gt.dtype == np.uint8 else 1.0
    if multichannel and gt.ndim == 3:
        vals = [_ssim_single(gt[..., c], pred[..., c], data_range, win_size)
                for c in range(gt.shape[-1])]
        return float(np.mean(vals))
    return float(_ssim_single(gt, pred, data_range, win_size))


def lpips_distance(lpips_params, gt, pred):
    """LPIPS between uint8 HWC images, each mapped by x / 127.5 - 1, on the
    device of `lpips_params` (the port's param tree); None without
    weights."""
    if lpips_params is None:
        return None
    device = lpips_params["lins"][0].device

    def prep(img):
        x = np.asarray(img, dtype=np.float32) / 127.5 - 1.0
        return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (2, 0, 1))[None])).to(device)

    with torch.no_grad(), lpips_module.cudnn_scope(enabled=True, benchmark=False,
                                                   deterministic=True, allow_tf32=False):
        return float(lpips_module.lpips(lpips_params, prep(pred), prep(gt))[0])


def eval_metrics(gts, preds, lpips_params=None):
    """Mean SSIM, PSNR and LPIPS over uint8 image pairs; LPIPS None without
    weights."""
    results = {"ssim": [], "psnr": [], "lpips": []}
    for gt, pred in zip(gts, preds):
        results["ssim"].append(ssim(pred, gt, multichannel=True))
        results["psnr"].append(psnr(gt, pred))
        d = lpips_distance(lpips_params, gt, pred)
        if d is not None:
            results["lpips"].append(d)
    return {k: (float(np.mean(v)) if v else None) for k, v in results.items()}

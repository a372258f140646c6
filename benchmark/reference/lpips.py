"""LPIPS, AlexNet variant (Zhang et al. 2018), plain: a fixed shift and
scale, the five AlexNet convolutions (max pooling after the first two),
each layer's features unit-normalised over channels, squared differences
weighted by the 1x1 "lin" weights (clamped at 0), a spatial mean and a sum
over the layers. Weights: {"convs": [{"w", "b"}], "lins": [...]}."""

import torch
import torch.nn.functional as F

CONVS = [(64, 3, 11, 4, 2), (192, 64, 5, 1, 2), (384, 192, 3, 1, 1), (256, 384, 3, 1, 1),
         (256, 256, 3, 1, 1)]
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def distance(params, img0, img1):
    """[B] distances of NCHW images in [-1, 1]."""
    shift = torch.tensor(SHIFT, device=img0.device)[None, :, None, None]
    scale = torch.tensor(SCALE, device=img0.device)[None, :, None, None]

    def feats(x):
        out = []
        x = (x - shift) / scale
        for i, (_, _, _, stride, pad) in enumerate(CONVS):
            c = params["convs"][i]
            x = torch.relu(F.conv2d(x, c["w"], c["b"], stride=stride, padding=pad))
            out.append(x)
            if i < 2:
                x = F.max_pool2d(x, 3, 2)
        return out

    unit = lambda f: f / (torch.sqrt((f * f).sum(1, keepdim=True)) + 1e-10)
    total = 0.0
    for a, b, lin in zip(feats(img0), feats(img1), params["lins"]):
        d = (unit(a) - unit(b)) ** 2
        total = total + (d * lin.clamp(min=0.0)[None, :, None, None]).sum(1).mean((1, 2))
    return total

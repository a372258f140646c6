"""Host-side scene helpers (the port's copy of the numpy branches of
neuman_tpu/utils/misc.py and neuman_tpu/native_bridge.py)."""

import numpy as np
from scipy import ndimage


def print_notification(content_list, notification_type="NOTIFICATION"):
    print(f"---------------------- {notification_type} ----------------------")
    for content in content_list:
        print(content)
    print("----------------------------------------------------")


def add_border_mask(scene, iterations=10):
    """Give every capture a `border_mask`: the ring that `iterations`
    dilations by the 4-connected cross add around its binary mask."""
    for cap in scene.captures:
        mask = cap.binary_mask
        if iterations > 0:
            dilated = ndimage.binary_dilation(np.ascontiguousarray(mask, np.uint8),
                                              iterations=iterations)
            cap.border_mask = dilated.astype(np.uint8).astype(mask.dtype) - mask
        else:
            cap.border_mask = mask - mask


def fused_depth(mvs, mono, mask):
    """`mvs` with its holes (depth 0, or on the human) filled by
    slope * mono + intercept, the line fitted by least squares to
    (mono, mvs) on the valid pixels. Raises ValueError on fewer than 2
    valid pixels."""
    valid = (mvs > 0) & (mask == 0)
    if valid.sum() < 2:
        raise ValueError("degenerate mono->mvs depth fit: fewer than 2 valid pixels")
    slope, intercept = np.polyfit(mono[valid], mvs[valid], 1)
    out = mvs.copy()
    out[~valid] = mono[~valid] * slope + intercept
    return out

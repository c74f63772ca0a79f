"""Challenge-protocol metrics (larvanet_tpu/eval/metrics.py:30-57).

Round, then clip to [0, 255], crop the truth to the output's size, RGB
PSNR with peak 255 (reference validate.py:17-27). `psnr_rgb_device` is
the on-device twin of the JAX package's `_val_psnr_impl`
(models/base.py:578-590): only a scalar crosses back to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def image_to_uint8(image: np.ndarray) -> np.ndarray:
    """Round (half to even) then clip to [0, 255], uint8."""
    return np.clip(np.round(image), 0, 255).astype(np.uint8)


def psnr_rgb(output_image: np.ndarray, truth_image: np.ndarray) -> float:
    """RGB PSNR, peak 255, on host arrays of one layout."""
    diff = np.float32(truth_image) - np.float32(output_image)
    mse = np.mean(np.square(diff))
    return float(10.0 * np.log10(255.0 ** 2 / mse))


def psnr_rgb_device(output_nhwc: torch.Tensor, truth_nhwc: torch.Tensor) -> torch.Tensor:
    """RGB PSNR of two NHWC batches on the device, both quantized as the
    protocol does; the truth is cropped to the output. A 0-d f32 tensor."""
    o = torch.clamp(torch.round(output_nhwc.float()), 0, 255)
    t = torch.clamp(torch.round(truth_nhwc.float()), 0, 255)
    t = t[:, : o.shape[1], : o.shape[2], :]
    mse = torch.mean(torch.square(t - o))
    return 10.0 * torch.log10(255.0 ** 2 / mse)

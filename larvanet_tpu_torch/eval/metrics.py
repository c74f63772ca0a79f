"""Evaluation metrics (larvanet_tpu/eval/metrics.py:30-154).

Two protocols, as in the reference:

* challenge (reference validate.py:17-27): round, then clip to [0, 255],
  crop the truth to the output's size, RGB PSNR with peak 255;
* paper (reference test.py:30-46,152-170): shave `scale` pixels, the Y
  channel of YCbCr as skimage's rgb2ycbcr computes it, rounded to uint8,
  then PSNR and SSIM (K1 = 0.01, K2 = 0.03, 11x11 Gaussian window with
  sigma 1.5 truncated at 3.5 sigma, population covariance).

The host functions take numpy arrays. `psnr_rgb_device` is the on-device
twin of the JAX package's `_val_psnr_impl` (models/base.py:578-590): only
a scalar crosses back to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def image_to_uint8(image: np.ndarray) -> np.ndarray:
    """Round (half to even) then clip to [0, 255], uint8."""
    return np.clip(np.round(image), 0, 255).astype(np.uint8)


def fit_truth_to_output(output_image: np.ndarray, truth_image: np.ndarray) -> np.ndarray:
    """Crop the truth to the output's spatial size; HWC or CHW."""
    if output_image.ndim != truth_image.ndim:
        raise ValueError("rank mismatch")
    if output_image.shape[-1] <= 4 and output_image.ndim == 3:  # HWC
        return truth_image[: output_image.shape[0], : output_image.shape[1], :]
    return truth_image[:, : output_image.shape[1], : output_image.shape[2]]


def shave(img: np.ndarray, border: int) -> np.ndarray:
    """Trim `border` pixels from each spatial edge of an HWC image."""
    return img[border:-border, border:-border, :]


def psnr_rgb(output_image: np.ndarray, truth_image: np.ndarray) -> float:
    """RGB PSNR, peak 255, on host arrays of one layout."""
    diff = np.float32(truth_image) - np.float32(output_image)
    mse = np.mean(np.square(diff))
    return float(10.0 * np.log10(255.0 ** 2 / mse))


_Y_COEFF = np.array([65.481, 128.553, 24.966], dtype=np.float64) / 255.0
_Y_OFFSET = 16.0


def rgb_to_y(image_hwc: np.ndarray) -> np.ndarray:
    """Y of YCbCr as skimage.color.rgb2ycbcr gives it for uint8 input:
    float64 in [16, 235]."""
    return np.asarray(image_hwc, dtype=np.float64) @ _Y_COEFF + _Y_OFFSET


def psnr_y(output_hwc: np.ndarray, truth_hwc: np.ndarray) -> float:
    """PSNR of the uint8-rounded Y planes, peak 255 (reference
    test.py:159-169)."""
    oy = image_to_uint8(rgb_to_y(output_hwc))
    ty = image_to_uint8(rgb_to_y(truth_hwc))
    mse = np.mean(np.square(np.float64(ty) - np.float64(oy)))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(255.0 ** 2 / mse))


def _gaussian_kernel(sigma: float = 1.5, truncate: float = 3.5) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _filter_valid(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Separable 'valid' correlation of a 2-D array with a 1-D kernel."""
    k = len(kernel)
    rows = img.shape[0] - k + 1
    out = np.zeros((rows, img.shape[1]), dtype=np.float64)
    for t in range(k):
        out += kernel[t] * img[t:t + rows, :]
    cols = out.shape[1] - k + 1
    out2 = np.zeros((rows, cols), dtype=np.float64)
    for t in range(k):
        out2 += kernel[t] * out[:, t:t + cols]
    return out2


def _ssim_single(x, y, data_range, k1, k2, sigma) -> float:
    kernel = _gaussian_kernel(sigma)
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    ux, uy = _filter_valid(x, kernel), _filter_valid(y, kernel)
    uxx, uyy = _filter_valid(x * x, kernel), _filter_valid(y * y, kernel)
    uxy = _filter_valid(x * y, kernel)
    vx, vy, vxy = uxx - ux * ux, uyy - uy * uy, uxy - ux * uy
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    num = (2.0 * ux * uy + c1) * (2.0 * vxy + c2)
    den = (ux * ux + uy * uy + c1) * (vx + vy + c2)
    return float(np.mean(num / den))


def ssim(im1: np.ndarray, im2: np.ndarray, data_range: float = 255.0,
         k1: float = 0.01, k2: float = 0.03, sigma: float = 1.5) -> float:
    """SSIM as the reference's skimage call computes it (test.py:43-46:
    gaussian_weights, sigma 1.5, population covariance, the window's
    border cropped); HWC RGB averages the three channels."""
    if im1.shape != im2.shape:
        raise ValueError("shape mismatch: %s vs %s" % (im1.shape, im2.shape))
    if im1.ndim == 3 and im1.shape[-1] == 3:
        return float(np.mean([_ssim_single(im1[..., c], im2[..., c], data_range,
                                           k1, k2, sigma) for c in range(3)]))
    return _ssim_single(im1, im2, data_range, k1, k2, sigma)


def psnr_rgb_device(output_nhwc: torch.Tensor, truth_nhwc: torch.Tensor) -> torch.Tensor:
    """RGB PSNR of two NHWC batches on the device, both quantized as the
    protocol does; the truth is cropped to the output. A 0-d f32 tensor."""
    o = torch.clamp(torch.round(output_nhwc.float()), 0, 255)
    t = torch.clamp(torch.round(truth_nhwc.float()), 0, 255)
    t = t[:, : o.shape[1], : o.shape[2], :]
    mse = torch.mean(torch.square(t - o))
    return 10.0 * torch.log10(255.0 ** 2 / mse)

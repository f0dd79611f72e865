"""Frame-level QA metrics (numpy and scipy; an offline evaluation path).

Port of simplenerf_tpu/qa/metrics.py, the same numpy and scipy code so
the scores are identical: the reference's 14 metric families (src/qa/):
RMSE/PSNR/SSIM/LPIPS, their visibility-masked variants, and depth RMSE /
median-scaled MAE / Spearman SROCC with masked variants.

- PSNR on the uint8 scale, 10*log10(255^2/mse); masked PSNR normalizes by
  the mask count;
- SSIM is skimage's structural_similarity with gaussian_weights=True,
  sigma=1.5, use_sample_covariance=False, written on
  scipy.ndimage.gaussian_filter; masked SSIM splices GT into masked-out
  pixels and averages the full (uncropped) SSIM map over the mask;
- depth MAE scales both depths by median(gt);
- masked LPIPS splices GT into masked-out pixels before the network.

LPIPS needs pretrained AlexNet features: the `lpips` package is used when
it imports, else both LPIPS metrics return None and the runner lists them
as skipped. No weights are fetched here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy.ndimage import gaussian_filter
from scipy.stats import spearmanr

# --------------------------------------------------------------- RGB metrics


def rmse(gt: np.ndarray, pred: np.ndarray) -> float:
    err = gt.astype(float) - pred.astype(float)
    return float(np.sqrt(np.mean(np.square(err))))


def masked_rmse(gt: np.ndarray, pred: np.ndarray, mask: np.ndarray) -> float:
    err = gt.astype(float) - pred.astype(float)
    mask3 = np.stack([mask] * 3, axis=2)
    return float(np.sqrt(np.sum(np.square(mask3 * err)) / np.sum(mask3)))


def psnr(gt: np.ndarray, pred: np.ndarray) -> float:
    err = gt.astype(float) - pred.astype(float)
    mse = np.mean(np.square(err))
    return float(10 * np.log10(255**2 / mse))


def masked_psnr(gt: np.ndarray, pred: np.ndarray, mask: np.ndarray) -> float:
    err = gt.astype(float) - pred.astype(float)
    mask3 = np.stack([mask] * 3, axis=2)
    mse = np.sum(np.square(mask3 * err)) / np.sum(mask3)
    return float(10 * np.log10(255**2 / mse))


def _ssim_single(gt: np.ndarray, pred: np.ndarray, data_range: float, sigma: float = 1.5):
    """SSIM map for one channel: gaussian windows, population covariance."""
    x = gt.astype(np.float64)
    y = pred.astype(np.float64)
    truncate = 3.5

    def filt(im):
        return gaussian_filter(im, sigma, truncate=truncate)

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = uxx - ux * ux
    vy = uyy - uy * uy
    vxy = uxy - ux * uy
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    return ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))


def ssim(gt: np.ndarray, pred: np.ndarray, data_range: float = 255.0, full: bool = False):
    """Multichannel SSIM; crops the filter radius for the scalar score."""
    sigma, truncate = 1.5, 3.5
    r = int(truncate * sigma + 0.5)
    maps = np.stack(
        [_ssim_single(gt[..., c], pred[..., c], data_range, sigma) for c in range(gt.shape[-1])],
        axis=-1,
    )
    score = float(np.mean(maps[r:-r, r:-r]))
    if full:
        return score, maps
    return score


def masked_ssim(gt: np.ndarray, pred: np.ndarray, mask: np.ndarray) -> float:
    mask3 = np.stack([mask] * 3, axis=2)
    spliced = mask3 * pred + (~mask3) * gt
    _, ssim_map = ssim(gt, spliced, full=True)
    return float(np.sum(mask3 * ssim_map) / np.sum(mask3))


# --------------------------------------------------------------- LPIPS

_lpips_model = None


def _get_lpips():
    """The LPIPS network (built once), or False without the `lpips` package."""
    global _lpips_model
    if _lpips_model is None:
        try:
            import lpips as lpips_pkg
        except ImportError:
            _lpips_model = False
        else:
            _lpips_model = lpips_pkg.LPIPS(net="alex")
    return _lpips_model


def lpips_available() -> bool:
    return _get_lpips() is not False


def _im2tensor(frame: np.ndarray) -> torch.Tensor:
    norm = frame.astype("float32") * 2 / 255 - 1
    return torch.from_numpy(np.moveaxis(norm, [0, 1, 2], [1, 2, 0]))[None]


def lpips(gt: np.ndarray, pred: np.ndarray) -> Optional[float]:
    model = _get_lpips()
    if model is False:
        return None
    return float(model(_im2tensor(gt), _im2tensor(pred)).item())


def masked_lpips(gt: np.ndarray, pred: np.ndarray, mask: np.ndarray) -> Optional[float]:
    model = _get_lpips()
    if model is False:
        return None
    mask3 = np.stack([mask] * 3, axis=2)
    spliced = mask3 * pred + (~mask3) * gt
    return float(model(_im2tensor(gt), _im2tensor(spliced)).item())


# --------------------------------------------------------------- depth metrics


def depth_rmse(gt: np.ndarray, pred: np.ndarray) -> float:
    err = gt.astype(float) - pred.astype(float)
    return float(np.sqrt(np.mean(np.square(err))))


def masked_depth_rmse(gt: np.ndarray, pred: np.ndarray, mask: np.ndarray) -> float:
    err = gt.astype(float) - pred.astype(float)
    return float(np.sqrt(np.sum(np.square(mask * err)) / np.sum(mask)))


def depth_mae(gt: np.ndarray, pred: np.ndarray) -> float:
    scale = np.median(gt)
    err = gt.astype(float) / scale - pred.astype(float) / scale
    return float(np.mean(np.abs(err)))


def masked_depth_mae(gt: np.ndarray, pred: np.ndarray, mask: np.ndarray) -> float:
    scale = np.median(gt)
    err = gt.astype(float) / scale - pred.astype(float) / scale
    return float(np.sum(np.abs(mask * err)) / np.sum(mask))


def depth_srocc(gt: np.ndarray, pred: np.ndarray) -> float:
    return float(spearmanr(gt.astype(float).ravel(), pred.astype(float).ravel()).correlation)


def masked_depth_srocc(gt: np.ndarray, pred: np.ndarray, mask: np.ndarray) -> float:
    m = mask.astype(bool)
    return float(spearmanr(gt[m].astype(float), pred[m].astype(float)).correlation)


def combine_visibility_masks(masks: np.ndarray) -> np.ndarray:
    """Pixel is 'visible' when seen in >= 2 train views
    (MaskedPSNR02_NeRF_LLFF.py:82-83)."""
    return np.sum(masks.astype(int), axis=0) > 1

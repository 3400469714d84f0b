"""Robust M-estimators on masked tensors (port of ``ptam_cg_tpu.utils.mest``).

``find_sigma_squared`` reproduces the reference's MAD-style formula
``sigma = 1.4826 * (1 + 5/(2n - 6)) * sqrt(median(err^2)) * c`` with the
median taken as ``sorted(valid)[n // 2]``.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

TUKEY = 0
CAUCHY = 1
HUBER = 2
LSQ = 3

_NAMES = {"tukey": TUKEY, "cauchy": CAUCHY, "huber": HUBER,
          "leastsquares": LSQ, "lsq": LSQ}

_SIGMA_SCALE = {TUKEY: 4.6851, CAUCHY: 4.6851, HUBER: 1.345, LSQ: 1.0}

_BIG = torch.finfo(torch.float32).max


def estimator_id(name: str) -> int:
    return _NAMES[name.lower()]


def masked_median(values: Tensor, mask: Tensor) -> Tensor:
    """sorted(valid)[n_valid // 2] of a 1-D tensor; invalid entries are
    pushed to the float32 maximum before sorting."""
    v = torch.sort(torch.where(mask, values, _BIG)).values
    n = torch.sum(mask.to(torch.int64))
    idx = torch.clamp(n // 2, 0, values.shape[-1] - 1)
    # gather, not v[idx]: a 0-d index tensor would be read on the host.
    return torch.gather(v, 0, idx.reshape(1))[0]


def masked_median_approx(values: Tensor, mask: Tensor) -> Tensor:
    """Median of per-row medians over rows of about sqrt(N) entries (the
    JAX package's approximation, kept for parity)."""
    n = values.shape[-1]
    rows = 1
    while rows * rows < n:
        rows *= 2
    cols = -(-n // rows)
    pad = rows * cols - n
    v = torch.where(mask, values, _BIG)
    v = torch.cat([v, v.new_full((pad,), _BIG)])
    m = torch.cat([mask, mask.new_zeros(pad)])
    v2 = torch.sort(v.reshape(rows, cols), dim=-1).values
    cnt = torch.sum(m.reshape(rows, cols).to(torch.int64), dim=-1)
    idx = torch.clamp(cnt // 2, 0, cols - 1)
    row_med = torch.gather(v2, 1, idx[:, None])[:, 0]
    return masked_median(row_med, cnt > 0)


def find_sigma_squared(err_sq: Tensor, mask: Tensor, kind: int = TUKEY,
                       min_sigma: float = 0.0,
                       approx: bool = False) -> Tensor:
    """Robust sigma^2 from masked squared errors."""
    n = torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)
    use_approx = approx and err_sq.shape[-1] >= 512
    median_fn = masked_median_approx if use_approx else masked_median
    median_sq = median_fn(err_sq, mask)
    if kind == LSQ:
        return torch.sum(torch.where(mask, err_sq, 0.0)) / n
    denom = torch.clamp(2.0 * n - 6.0, min=1.0)
    sigma = 1.4826 * (1.0 + 5.0 / denom) * torch.sqrt(
        torch.clamp(median_sq, min=0.0))
    sigma = _SIGMA_SCALE[kind] * sigma
    sigma = torch.clamp(sigma, min=min_sigma)
    return sigma * sigma


def weight(err_sq: Tensor, sigma_sq: Tensor, kind: int = TUKEY) -> Tensor:
    """Per-residual IRLS weight."""
    s = torch.clamp(sigma_sq, min=1e-12)
    if kind == TUKEY:
        w = 1.0 - err_sq / s
        return torch.where(err_sq > s, 0.0, w * w)
    if kind == CAUCHY:
        return 1.0 / (1.0 + err_sq / s)
    if kind == HUBER:
        return torch.where(err_sq < s, 1.0,
                           torch.sqrt(s / torch.clamp(err_sq, min=1e-12)))
    return torch.ones_like(err_sq)


def sqrt_weight(err_sq: Tensor, sigma_sq: Tensor, kind: int = TUKEY) -> Tensor:
    """Square root of ``weight`` (Tukey's in closed form)."""
    s = torch.clamp(sigma_sq, min=1e-12)
    if kind == TUKEY:
        return torch.where(err_sq > s, 0.0, 1.0 - err_sq / s)
    return torch.sqrt(weight(err_sq, sigma_sq, kind))


def objective(err_sq: Tensor, sigma_sq: Tensor, kind: int = TUKEY) -> Tensor:
    """Robust objective score; Tukey's is scaled as in the reference (no
    sigma^2/6 factor)."""
    s = torch.clamp(sigma_sq, min=1e-12)
    if kind == TUKEY:
        d = 1.0 - err_sq / s
        return torch.where(err_sq > s, 1.0, 1.0 - d * d * d)
    if kind == CAUCHY:
        return torch.log1p(err_sq / s)
    if kind == HUBER:
        sig = torch.sqrt(s)
        err = torch.sqrt(torch.clamp(err_sq, min=0.0))
        return torch.where(err_sq < s, 0.5 * err_sq, sig * (err - 0.5 * sig))
    return err_sq

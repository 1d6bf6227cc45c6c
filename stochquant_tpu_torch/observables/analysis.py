"""Statistical analysis (port of ``stochquant_tpu.observables.analysis``):
autocorrelation-aware errors, jackknife, and energy-gap extraction.

The reference's validation is a human watching a plot; these routines turn
"within statistical error" into a computation: the integrated
autocorrelation time by Sokal's windowing rule, binned jackknife errors, and
the energy gap E₁−E₀ from the exponential decay of the connected correlator
(the slope of the log|C(t)| the reference streams, ``tauhost.c:491``).  They
run in float64 numpy; a PyTorch tensor (on any device) is taken as its
values.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


def _values(x) -> np.ndarray:
    """float64 numpy values of an array or a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


def autocorr_time(series, c: float = 5.0) -> float:
    """Integrated autocorrelation time with Sokal's self-consistent window
    (τ_int = ½ + Σ_t ρ(t), summed while window < c·τ_int)."""
    x = _values(series)
    x = x - x.mean()
    n = len(x)
    if n < 4 or np.allclose(x, 0):
        return 0.5
    f = np.fft.rfft(x, n=2 * n)
    acf = np.fft.irfft(f * np.conj(f))[:n].real
    if acf[0] <= 0:
        return 0.5
    rho = acf / acf[0]
    tau = 0.5
    for t in range(1, n):
        tau += rho[t]
        if t >= c * tau:
            break
    return max(tau, 0.5)


def binned_jackknife(samples, bin_size: Optional[int] = None) -> Tuple[float, float]:
    """(mean, error) of a 1-D sample series via binning + delete-1 jackknife.
    Default bin size ≈ 2·τ_int so bins are effectively independent."""
    x = _values(samples)
    n = len(x)
    if bin_size is None:
        bin_size = max(1, int(np.ceil(2.0 * autocorr_time(x))))
    nbins = n // bin_size
    if nbins < 2:
        return float(x.mean()), float(x.std(ddof=1) / np.sqrt(max(n - 1, 1)))
    binned = x[: nbins * bin_size].reshape(nbins, bin_size).mean(axis=1)
    total = binned.mean()
    jk = (binned.sum() - binned) / (nbins - 1)
    err = np.sqrt((nbins - 1) / nbins * np.sum((jk - jk.mean()) ** 2))
    return float(total), float(err)


class GapFit(NamedTuple):
    gap: float        # E₁ − E₀ in physical units (1/time)
    gap_err: float
    amplitude: float
    window: Tuple[int, int]


def energy_gap_from_correlator(
    corr,
    dt: float,
    mid: Optional[int] = None,
    fit_range: Optional[Tuple[int, int]] = None,
    corr_err=None,
) -> GapFit:
    """Extract E₁−E₀ from the connected correlator C(t) = ⟨x(t)x(t_mid)⟩_c.

    For large |t − t_mid|, C ∝ exp(−(E₁−E₀)|t−t_mid|): fit log|C| linearly
    in the separation (weighted if errors are given)."""
    corr = _values(corr)
    n = len(corr)
    if mid is None:
        mid = n // 2
    sep = np.abs(np.arange(n) - mid) * dt
    with np.errstate(divide="ignore"):
        logc = np.log(np.abs(corr))
    if fit_range is None:
        # separations between 10% and 60% of the largest: no contact term,
        # no noisy far tail
        smax = sep.max()
        lo, hi = 0.1 * smax, 0.6 * smax
        sel = (sep > lo) & (sep < hi) & np.isfinite(logc)
    else:
        sel = np.zeros(n, bool)
        sel[fit_range[0]: fit_range[1]] = True
        sel &= np.isfinite(logc)
    if sel.sum() < 3:
        raise ValueError("not enough valid points for a gap fit")
    w = None
    if corr_err is not None:
        rel = _values(corr_err)[sel] / np.maximum(np.abs(corr[sel]), 1e-300)
        w = 1.0 / np.maximum(rel, 1e-12) ** 2
    coeffs, cov = np.polyfit(sep[sel], logc[sel], 1, w=w, cov=True)
    slope, intercept = coeffs
    return GapFit(
        gap=float(-slope),
        gap_err=float(np.sqrt(max(cov[0, 0], 0.0))),
        amplitude=float(np.exp(intercept)),
        window=(int(np.argmax(sel)), int(n - np.argmax(sel[::-1]))),
    )


def cross_chain_error(per_chain_values) -> Tuple[float, float]:
    """(mean, stderr) over independent chains — chains are i.i.d. by
    construction (counter-based noise), so this is the cleanest estimate."""
    v = _values(per_chain_values)
    return float(v.mean()), float(v.std(ddof=1) / np.sqrt(len(v)))

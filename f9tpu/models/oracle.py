"""Float64 NumPy oracle for the rational resampler.

Independent, direct-form evaluation from the prototype phase bank (NOT via the
``(W, L)`` cycle matrix used by the device ops), so parity tests cross-check both
the cycle-matrix construction and the device execution path.  This plays the
role ``BASELINE.json`` assigns to JUCE's ``WindowedSincInterpolator`` /
``LagrangeInterpolator`` running on CPU: the accuracy reference the device output
must match to <= -120 dB RMS.  A C++ double-precision twin lives in
``f9tpu/native/f9native.cpp`` (``oracle_resample``, built lazily via ctypes —
see ``f9tpu/native/__init__.py``) for native cross-validation.
"""

from __future__ import annotations

import numpy as np

from .filters import (
    QUALITY_PRESETS,
    lagrange_phase_bank,
    minphase_phase_bank,
    resolve_ratio,
    sinc_phase_bank,
)

__all__ = ["resample_oracle"]


def _design(rate_in: int, rate_out: int, quality: str, kind: str, lagrange_order: int):
    import math

    L, M = resolve_ratio(rate_in, rate_out)
    if L == 1 and M == 1:
        return L, M, 1, np.ones((1, 1), dtype=np.float64), 0
    if kind in ("sinc", "minphase"):
        Z = QUALITY_PRESETS[quality]
        K = max(4, int(math.ceil(2.0 * Z * max(L, M) / L)))
        K += K % 2
        if kind == "minphase":
            H = minphase_phase_bank(L, M, K)
            delay = 0
        else:
            H = sinc_phase_bank(L, M, K)
            delay = (K * L) // 2
    elif kind == "lagrange":
        K = lagrange_order + 1
        H = lagrange_phase_bank(L, order=lagrange_order)
        delay = (lagrange_order // 2) * L
    else:
        raise ValueError(kind)
    return L, M, K, H, delay


def resample_oracle(
    x: np.ndarray,
    rate_in: int,
    rate_out: int,
    quality: str = "high",
    kind: str = "sinc",
    lagrange_order: int = 4,
    chunk: int = 1 << 16,
) -> np.ndarray:
    """Resample the last axis of ``x`` from ``rate_in`` to ``rate_out`` (float64).

    Output sample ``n`` estimates the input at exact position ``n*M/L`` (zero
    overall delay), matching the contract of :func:`f9tpu.ops.resample.resample`.
    """
    x = np.asarray(x, dtype=np.float64)
    L, M, K, H, delay = _design(rate_in, rate_out, quality, kind, lagrange_order)
    T = x.shape[-1]
    out_len = -(-T * L // M)
    lead = x.shape[:-1]
    xf = x.reshape(-1, T)
    y = np.zeros((xf.shape[0], out_len), dtype=np.float64)
    j = np.arange(K, dtype=np.int64)
    for start in range(0, out_len, chunk):
        n = np.arange(start, min(start + chunk, out_len), dtype=np.int64)
        u = n * M + delay
        base = u // L
        ph = (u % L).astype(np.int64)
        idx = base[:, None] - j[None, :]          # (n, K)
        valid = (idx >= 0) & (idx < T)
        idx_c = np.clip(idx, 0, T - 1)
        w = H[ph]                                  # (n, K)
        for b in range(xf.shape[0]):
            samples = np.where(valid, xf[b][idx_c], 0.0)
            y[b, start : start + len(n)] = np.einsum("nk,nk->n", w, samples)
    return y.reshape(*lead, out_len)

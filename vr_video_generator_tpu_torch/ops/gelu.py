"""The GELUs of the JAX package: the A&S 7.1.26 erf GELU of
vr_video_generator_tpu/ops/gelu.py in f32 (``gelu_exact``), and the tanh
approximation of ``jax.nn.gelu(x, approximate=True)`` (``gelu_tanh``,
``--gelu tanh``).

``gelu_exact`` is not torch's exact erf: the two differ by up to ~8e-7 in
f32, and this form flushes to -0.0 below x ~ -5.7. ``gelu_tanh`` is not
``F.gelu(approximate="tanh")``, which computes in f32 and rounds once: the
JAX function rounds every operation to x's dtype. The port keeps the JAX
package's numbers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_INV_SQRT2 = float(np.float32(1.0 / np.sqrt(2.0)))
_P = float(np.float32(0.3275911))
_A = tuple(float(np.float32(v)) for v in
           (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429))


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """0.5*x*(1+erf(x/sqrt(2))) with the A&S erf; f32 inside, x's dtype out."""
    xf = x.float()
    z = xf * _INV_SQRT2
    a = z.abs()
    t = 1.0 / (1.0 + _P * a)
    poly = t * (_A[0] + t * (_A[1] + t * (_A[2] + t * (_A[3] + t * _A[4]))))
    erf = torch.sign(z) * (1.0 - poly * torch.exp(-a * a))
    return (0.5 * xf * (1.0 + erf)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _tanh_consts(dtype: torch.dtype) -> tuple:
    """(0.044715, sqrt(2/pi)) rounded to ``dtype``, as jax.nn.gelu holds
    them: the first a weak-typed Python float, the second cast by numpy."""
    return tuple(float(torch.tensor(v, dtype=torch.float64).to(dtype))
                 for v in (0.044715, np.sqrt(2 / np.pi)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """0.5 * x * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))) in x's dtype,
    each operation rounded to it as jax.nn.gelu(x, approximate=True) rounds:
    x^3 as (x x) x, the constants in x's dtype, then x * cdf."""
    c, k = _tanh_consts(x.dtype)
    inner = (x + x * x * x * c) * k
    return x * (0.5 * (1.0 + torch.tanh(inner)))

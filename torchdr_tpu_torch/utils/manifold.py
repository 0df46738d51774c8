"""Poincaré ball operations (counterpart of ``torchdr_tpu/utils/manifold.py``).

Plain functions on tensors, with the JAX package's numerics: artanh
clamped to ±(1 − 1e-7), tanh's argument to ±15, norms floored at
``MIN_NORM`` and points projected into the ball of radius
(1 − ``BALL_EPS``)/√c. Curvature ``c`` defaults to 1.
"""

from __future__ import annotations

import torch

MIN_NORM = 1e-15
BALL_EPS = 4e-3  # float32 projection margin


def _artanh(x):
    x = torch.clamp(x, -1 + 1e-7, 1 - 1e-7)
    return 0.5 * (torch.log1p(x) - torch.log1p(-x))


def _tanh(x, clamp: float = 15.0):
    return torch.tanh(torch.clamp(x, -clamp, clamp))


def _norm(x, keepdims=True):
    return torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=keepdims), min=MIN_NORM)


def _dot(x, y):
    return torch.sum(x * y, dim=-1, keepdim=True)


def lambda_x(x, c: float = 1.0):
    """Conformal factor 2 / (1 - c‖x‖²)."""
    return 2.0 / torch.clamp(1.0 - c * _dot(x, x), min=MIN_NORM)


def mobius_add(x, y, c: float = 1.0):
    x2, y2, xy = _dot(x, x), _dot(y, y), _dot(x, y)
    num = (1 + 2 * c * xy + c * y2) * x + (1 - c * x2) * y
    denom = 1 + 2 * c * xy + c**2 * x2 * y2
    return num / torch.clamp(denom, min=MIN_NORM)


def poincare_project(x, c: float = 1.0):
    """Clamp points into the open ball of radius (1-eps)/√c."""
    norm = _norm(x)
    maxnorm = (1 - BALL_EPS) / (c**0.5)
    return torch.where(norm > maxnorm, x / norm * maxnorm, x)


def poincare_expmap(u, p, c: float = 1.0):
    sqrt_c = c**0.5
    u_norm = _norm(u)
    second = _tanh(sqrt_c / 2 * lambda_x(p, c) * u_norm) * u / (sqrt_c * u_norm)
    return mobius_add(p, second, c)


def poincare_expmap0(u, c: float = 1.0):
    sqrt_c = c**0.5
    u_norm = _norm(u)
    return _tanh(sqrt_c * u_norm) * u / (sqrt_c * u_norm)


def poincare_logmap(p1, p2, c: float = 1.0):
    sub = mobius_add(-p1, p2, c)
    sub_norm = _norm(sub)
    lam = lambda_x(p1, c)
    sqrt_c = c**0.5
    return 2 / sqrt_c / lam * _artanh(sqrt_c * sub_norm) * sub / sub_norm


def poincare_logmap0(p, c: float = 1.0):
    sqrt_c = c**0.5
    p_norm = _norm(p)
    return (1.0 / sqrt_c) * _artanh(sqrt_c * p_norm) / p_norm * p


def poincare_sqdist(p1, p2, c: float = 1.0):
    """Squared geodesic distance between aligned rows."""
    sqrt_c = c**0.5
    dist_c = _artanh(sqrt_c * _norm(mobius_add(-p1, p2, c), keepdims=False))
    return (dist_c * 2 / sqrt_c) ** 2


def egrad2rgrad(p, dp, c: float = 1.0):
    """Euclidean → Riemannian gradient (scale by 1/λ²)."""
    return dp / lambda_x(p, c) ** 2


def _gyration(u, v, w, c: float = 1.0):
    u2, v2, uv = _dot(u, u), _dot(v, v), _dot(u, v)
    uw, vw = _dot(u, w), _dot(v, w)
    c2 = c**2
    a = -c2 * uw * v2 + c * vw + 2 * c2 * uv * vw
    b = -c2 * vw * u2 - c * uw
    d = 1 + 2 * c * uv + c2 * u2 * v2
    return w + 2 * (a * u + b * v) / torch.clamp(d, min=MIN_NORM)


def poincare_ptransp(x, y, u, c: float = 1.0):
    """Parallel transport of tangent u from x to y (gyration form)."""
    return _gyration(y, -x, u, c) * lambda_x(x, c) / lambda_x(y, c)


def poincare_inner(x, u, v=None, c: float = 1.0, keepdims=True):
    if v is None:
        v = u
    return lambda_x(x, c) ** 2 * torch.sum(u * v, dim=-1, keepdim=keepdims)

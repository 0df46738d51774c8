"""One optimizer step's gradient, from the published losses.

UMAP (McInnes et al. 2018, in its negative-sampling form, Damrich &
Hamprecht 2021): the output kernel q = 1/(1 + a d^(2b)), with d² the squared
distance. At one step each visited edge (i, j) fires ``c_ij`` times and
attracts with 2ab d^(2b-2) / (1 + a d^(2b)) · c_ij · (z_i - z_j); every row is
repelled by one shared sample of S rows, each weighted by the row's fired
count times the negative rate over S, with -2b / ((d² + ε)(1 + a d^(2b))) ·
(z_i - z_s), its own id left out. Each part is clipped to ±4 per coordinate.

t-SNE (van der Maaten & Hinton 2008), as the loss
ee · Σ_ij P_ij log(1 + d²_ij) + log Σ_{i≠j} (1 + d²_ij)^-1 over a directed P:
the attraction 2 P_ij q_ij (z_i - z_j) on i and its opposite on j, the
repulsion -4 Σ_j q_ij² (z_i - z_j) / Σ_{k≠l} q_kl, computed over all pairs in
row blocks.

``dtype`` is float64 for the reference and bfloat16 for the control
(torch sums bfloat16 in float32 and rounds the result).
"""

from __future__ import annotations

import numpy as np
import torch


def umap_ab(spread: float, min_dist: float) -> tuple:
    """(a, b) of 1/(1 + a x^(2b)) fitted by least squares to UMAP's offset
    exponential (1 below ``min_dist``, exp(-(x - min_dist)/spread) above) on
    300 points of [0, 3·spread], as the UMAP paper's implementation fits it."""
    from scipy.optimize import curve_fit

    x = np.linspace(0, spread * 3, 300)
    y = np.where(x < min_dist, 1.0, np.exp(-(x - min_dist) / spread))
    (a, b), _ = curve_fit(lambda x, a, b: 1.0 / (1.0 + a * x ** (2 * b)), x, y)
    return float(a), float(b)


def umap_step(Z, nn, fired, neg, a: float, b: float, rate: float, eps: float = 1e-3,
              dtype=torch.float64, block: int = 65_536):
    """The (n, d) gradient of one UMAP step at Z over the visited edges
    ``nn`` (n, W) with fire counts ``fired`` (n, W) and the shared sample
    ``neg`` (S,)."""
    Z = Z.to(dtype)
    n = Z.shape[0]
    nn = nn.long()
    neg = neg.long()
    S = neg.shape[0]
    Zs = Z[neg]
    out = torch.empty_like(Z)
    for r0 in range(0, n, block):
        r = slice(r0, min(r0 + block, n))
        Zr = Z[r]
        diff = Zr[:, None, :] - Z[nn[r]]
        D = (diff * diff).sum(-1)
        t = D ** b
        coef = 2.0 * a * b * t / (D.clamp(min=1e-20) * (1.0 + a * t))
        coef = torch.where(D > 0, coef, torch.zeros_like(coef)) * fired[r].to(dtype)
        attr = (diff * coef[..., None]).sum(1).clamp(-4.0, 4.0)
        w = fired[r].to(dtype).sum(1) * rate / S
        diff = Zr[:, None, :] - Zs[None, :, :]
        D = (diff * diff).sum(-1)
        coef = -2.0 * b / ((D + eps) * (1.0 + a * D ** b))
        own = neg[None, :] == torch.arange(r0, r0 + Zr.shape[0], device=Z.device)[:, None]
        coef = torch.where(own, torch.zeros_like(coef), coef)
        rep = (w[:, None] * (diff * coef[..., None]).sum(1)).clamp(-4.0, 4.0)
        out[r] = attr + rep
    return out


def tsne_step(Z, P, ids, ee: float = 1.0, dtype=torch.float64, block: int = 512):
    """The (n, d) gradient of the t-SNE loss at Z over the directed P
    (n, k) on the neighbour ids (n, k) (ids < 0 are padding)."""
    Z = Z.to(dtype)
    n, d = Z.shape
    valid = ids >= 0
    j = ids.clamp(min=0).long()
    diff = Z[:, None, :] - Z[j]
    q = 1.0 / (1.0 + (diff * diff).sum(-1))
    f = (2.0 * P.to(dtype) * q * valid)[..., None] * diff
    attr = f.sum(1).index_add_(0, j.reshape(-1), -f.reshape(-1, d))
    total = torch.zeros((), dtype=torch.float64, device=Z.device)
    pull = torch.empty_like(Z)
    for r0 in range(0, n, block):
        r = slice(r0, min(r0 + block, n))
        diff = Z[r][:, None, :] - Z[None, :, :]
        q = 1.0 / (1.0 + (diff * diff).sum(-1))
        own = torch.arange(r0, r0 + q.shape[0], device=Z.device)
        q[torch.arange(q.shape[0], device=Z.device), own] = 0
        total += q.sum(dtype=torch.float64)
        pull[r] = ((q * q)[..., None] * diff).sum(1)
    return ee * attr - 4.0 * pull / total.to(dtype)

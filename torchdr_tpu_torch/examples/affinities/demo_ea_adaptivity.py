"""Entropic affinity adapts its bandwidth to local density (counterpart of
``examples/affinities/demo_ea_adaptivity.py``).

Run: python -m torchdr_tpu_torch.examples.affinities.demo_ea_adaptivity [--device cpu]

Gate: each row's calibrated bandwidth ``eps_`` within ``TOL`` (relative) of
the JAX package's on the same rows.
"""

import numpy as np

from torchdr_tpu_torch.affinity import EntropicAffinity, NormalizedGaussianAffinity
from torchdr_tpu_torch.examples._common import jax_reference, parser

SCRIPT = "affinities/demo_ea_adaptivity"
TOL = 1e-4


def _host(a):
    return np.asarray(a.cpu() if hasattr(a, "cpu") else a, np.float64)


def row_perplexity(P):
    # row-normalize, then perplexity = exp(shannon entropy)
    P = P / P.sum(axis=1, keepdims=True)
    H = -np.sum(np.where(P > 0, P * np.log(np.maximum(P, 1e-30)), 0.0), axis=1)
    return np.exp(H)


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev = args.device
    rng = np.random.default_rng(0)
    # two clusters with a 10x density contrast
    dense = rng.normal(scale=0.1, size=(150, 2))
    sparse = np.array([4.0, 0.0]) + rng.normal(scale=1.0, size=(150, 2))
    X = np.concatenate([dense, sparse]).astype(np.float32)

    ea = EntropicAffinity(perplexity=30, sparsity=False, device=dev)
    P, _ = ea(X)
    pp = row_perplexity(_host(P))
    eps = _host(ea.eps_)
    print(f"EntropicAffinity row perplexities: dense cluster "
          f"{pp[:150].mean():.1f}, sparse cluster {pp[150:].mean():.1f} "
          f"(target 30 everywhere)")
    print(f"calibrated eps range: {eps.min():.4f} .. "
          f"{eps.max():.4f} (adapts ~1000x across densities)")

    # fixed-bandwidth Gaussian: effective neighborhood varies with density
    ga = NormalizedGaussianAffinity(sigma=1.0, normalization_dim=1, device=dev)
    ppg = row_perplexity(_host(ga(X)))
    print(f"fixed-sigma Gaussian row perplexities: dense {ppg[:150].mean():.1f}, "
          f"sparse {ppg[150:].mean():.1f} (no adaptivity)")

    want = np.asarray(jax_reference(SCRIPT)["eps"])
    rel = np.abs(eps - want) / np.abs(want)
    if not (np.all(np.isfinite(eps)) and rel.max() <= TOL):
        raise AssertionError(f"{SCRIPT}: eps_ {rel.max():.3e} (relative) from the JAX package's")
    return {"eps": eps, "eps_max_rel_err": float(rel.max()), "ea_perplexity": pp,
            "gaussian_perplexity": ppg}


if __name__ == "__main__":
    main()

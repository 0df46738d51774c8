"""PCA via SVD and via AffinityMatcher (counterpart of
``examples/basics/demo_pca_via_affinity_matcher.py``).

A custom scalar-product Affinity plugged into AffinityMatcher with the
square loss recovers the PCA subspace: the user-extension API (subclass
Affinity, override ``_compute_affinity``) end to end through the fit loop.
The data are the JAX script's without scikit-learn: 500 x 64 normal rows.
The fit starts from the JAX script's ``init="normal"`` draw, read from
``jax_reference.json``: torch's generator draws other numbers, and where
500 steps leave the fit depends on the draw, in either package.

Run: python -m torchdr_tpu_torch.examples.basics.demo_pca_via_affinity_matcher [--device cpu]

Gate: the subspace alignment within ``TOL`` of the JAX script's.
"""

import numpy as np

import torchdr_tpu_torch as tdt
from torchdr_tpu_torch.affinity import Affinity
from torchdr_tpu_torch.examples._common import check_embedding, jax_reference, parser

SCRIPT = "basics/demo_pca_via_affinity_matcher"
TOL = 1e-3


class ScalarProductAffinity(Affinity):
    """Scalar-product affinity X @ X.T (the reference demo's custom class)."""

    def __init__(self, device="auto", verbose=False):
        super().__init__(device=device, verbose=verbose, zero_diag=False)

    def _compute_affinity(self, X, **kwargs):
        return X @ X.T


def subspace_alignment(A, B):
    """Mean principal-angle cosine between the column spaces of A and B."""
    Qa, _ = np.linalg.qr(A)
    Qb, _ = np.linalg.qr(B)
    s = np.linalg.svd(Qa.T @ Qb, compute_uv=False)
    return float(s.mean())


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev = args.device
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 64)).astype(np.float32)
    X = X - X.mean(axis=0)

    # Closed-form PCA.
    Z_pca = np.asarray(tdt.PCA(n_components=2, random_state=0, device=dev).fit_transform(X))

    # Same solution through the generic affinity-matching engine.
    ref = jax_reference(SCRIPT)
    model = tdt.AffinityMatcher(
        affinity_in=ScalarProductAffinity(device=dev),
        affinity_out=ScalarProductAffinity(device=dev),
        loss_fn="square_loss",
        init=np.asarray(ref["init"], np.float32),
        lr=1e1,
        max_iter=500,
        random_state=0,
        verbose=True,
        device=dev,
    )
    Z_am = np.asarray(model.fit_transform(X))

    align = subspace_alignment(Z_pca, Z_am)
    print(f"PCA vs AffinityMatcher subspace alignment: {align:.4f} (1.0 = identical)")

    check_embedding(SCRIPT, "PCA", Z_pca)
    check_embedding(SCRIPT, "AffinityMatcher", Z_am)
    want = ref["alignment"]
    if not abs(align - want) <= TOL:
        raise AssertionError(f"{SCRIPT}: alignment {align:.6f}, the JAX script's {want:.6f}")
    return {"fits": {"PCA": {"embedding": Z_pca}, "AffinityMatcher": {"embedding": Z_am}},
            "alignment": align}


if __name__ == "__main__":
    main()

"""Streaming PCA over batches (counterpart of
``examples/basics/incremental_pca.py``).

Run: python -m torchdr_tpu_torch.examples.basics.incremental_pca [--device cpu]

Gate: each fit's explained variance within ``TOL`` (relative) of the JAX
package's on the same batches, and IncrementalPCA's ratio within ``TOL``.
"""

import numpy as np

import torchdr_tpu_torch as tdt
from torchdr_tpu_torch.examples._common import check_embedding, jax_reference, parser

SCRIPT = "basics/incremental_pca"
TOL = 1e-5


def batch_stream(n_batches=20, batch=512, d=64, seed=0):
    rng = np.random.default_rng(seed)
    basis = rng.normal(size=(8, d)) * np.linspace(10, 1, 8)[:, None]
    for _ in range(n_batches):
        coeff = rng.normal(size=(batch, 8))
        yield (coeff @ basis + rng.normal(size=(batch, d)) * 0.1).astype(np.float32)


def _array(v):
    return np.asarray(v.cpu() if hasattr(v, "cpu") else v, np.float64)


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev = args.device

    # one-pass approximate (Ross et al. incremental SVD)
    ipca = tdt.IncrementalPCA(n_components=4, device=dev)
    Z = np.asarray(ipca.fit_transform(batch_stream()))
    print(f"IncrementalPCA: {Z.shape}, "
          f"explained variance ratio = {np.round(_array(ipca.explained_variance_ratio_), 3)}")

    # two-pass exact (covariance accumulation)
    epca = tdt.ExactIncrementalPCA(n_components=4, batch_size=512, device=dev)
    Z2 = np.asarray(epca.fit_transform(list(batch_stream())))
    print(f"ExactIncrementalPCA: {Z2.shape}, "
          f"explained variance = {np.round(_array(epca.explained_variance_), 2)}")

    out = {"fits": {"IncrementalPCA": {"embedding": Z}, "ExactIncrementalPCA": {"embedding": Z2}}}
    ref = jax_reference(SCRIPT)
    for name, model in (("IncrementalPCA", ipca), ("ExactIncrementalPCA", epca)):
        check_embedding(SCRIPT, name, out["fits"][name]["embedding"])
        var, want = _array(model.explained_variance_), np.asarray(ref[name]["explained_variance"])
        out[name] = {"explained_variance": var.tolist()}
        ok = np.all(np.abs(var - want) <= TOL * np.abs(want))
        if hasattr(model, "explained_variance_ratio_"):
            ratio = _array(model.explained_variance_ratio_)
            out[name]["explained_variance_ratio"] = ratio.tolist()
            ok = ok and np.all(np.abs(ratio - np.asarray(ref[name]["explained_variance_ratio"]))
                               <= TOL)
        if not ok:
            raise AssertionError(f"{SCRIPT} {name}: {out[name]}, the JAX package's {ref[name]}")
    return out


if __name__ == "__main__":
    main()

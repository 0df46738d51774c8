"""TSNE on the swiss roll (counterpart of
``examples/basics/demo_tsne_swiss_roll.py``).

Run: python -m torchdr_tpu_torch.examples.basics.demo_tsne_swiss_roll [--device cpu]

Gate: the neighbourhood preservation@15 within ``TOL`` of the JAX script's
on the same 1,000 rows.
"""

import os
import tempfile

import numpy as np

import torchdr_tpu_torch as tdt
from torchdr_tpu_torch.examples._common import (
    check_embedding,
    jax_reference,
    parser,
    timed_fit,
)
from torchdr_tpu_torch.examples._data import make_swiss_roll

SCRIPT = "basics/demo_tsne_swiss_roll"
TOL = 0.05


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev = args.device
    X, t = make_swiss_roll(n_samples=1000, noise=0.05, random_state=0)
    X = X.astype(np.float32)

    Z, seconds = timed_fit(tdt.TSNE(perplexity=30, max_iter=800, random_state=0, device=dev), X)
    pres = tdt.neighborhood_preservation(X, Z, K=15, device=dev)
    print(f"TSNE swiss-roll: embedding {Z.shape}, "
          f"neighborhood preservation@15 = {pres:.3f}")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out = os.path.join(tempfile.gettempdir(), "tsne_swiss_roll.png")
        plt.scatter(*Z.T, c=t, s=3, cmap="viridis")
        plt.title("TSNE on swiss roll")
        plt.savefig(out, dpi=120)
        plt.close()
        print(f"saved {out}")
    except ImportError:
        pass

    check_embedding(SCRIPT, "TSNE", Z)
    want = jax_reference(SCRIPT)["preservation"]
    if not abs(pres - want) <= TOL:
        raise AssertionError(f"{SCRIPT}: preservation {pres:.4f}, the JAX script's {want:.4f}")
    return {"fits": {"TSNE": {"embedding": Z, "seconds": seconds, "preservation": pres}},
            "preservation": pres}


if __name__ == "__main__":
    main()

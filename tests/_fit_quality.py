"""One estimator's fit on ``chip_smoke.py``'s data: its steps, the gradient
norm at its last convergence check, wall time and 10-NN label accuracy
(``chip_smoke.knn_label_accuracy``), in the JAX package (on the CPU) or in
the port (on the card by default). It is the evidence
for the defaults that ``chip_smoke.py`` sets: a default that misses the
accuracy gate or stops a fit early is shown in both packages.

    python tests/_fit_quality.py jax InfoTSNE 60000
    python tests/_fit_quality.py port InfoTSNE 60000 lr=1500.0
    python tests/_fit_quality.py port TSNEkhorn 2000 min_grad_norm=1e-7 --device cpu

The rows are ``benchmarks.ivf_recall.make_clustered(n, 784, 50, seed=0)``;
each ``key=value`` is a constructor argument (``random_state=0`` always).
It prints one JSON line.
"""

import argparse
import ast
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _value(text):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=("jax", "port"))
    ap.add_argument("model")
    ap.add_argument("n", type=int)
    ap.add_argument("params", nargs="*", help="key=value constructor arguments")
    ap.add_argument("--device", default="auto", help="the port's device (auto: the card)")
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from chip_smoke import knn_label_accuracy
    from torchdr_tpu_torch.benchmarks.ivf_recall import make_clustered

    params = dict(p.split("=", 1) for p in a.params)
    params = {k: _value(v) for k, v in params.items()}
    X, labels = make_clustered(a.n, 784, 50, seed=0)
    if a.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import torchdr_tpu

        model = getattr(torchdr_tpu, a.model)(random_state=0, **params)
        device = "cpu"
    else:
        import torchdr_tpu_torch

        model = getattr(torchdr_tpu_torch, a.model)(random_state=0, device=a.device, **params)
        device = str(model._resolve_device())
    t0 = time.perf_counter()
    Z = np.asarray(model.fit_transform(X))
    wall = time.perf_counter() - t0
    dev = torch.device(device)
    acc = knn_label_accuracy(torch, torch.from_numpy(Z).to(dev), torch.from_numpy(labels).to(dev))
    print(json.dumps({
        "package": a.package, "model": a.model, "n": a.n, "params": params,
        "steps": int(model.n_iter_), "grad_norm": float(model._last_grad_norm_), "wall_s": wall,
        "knn10_label_acc": acc,
        "finite": bool(np.isfinite(Z).all()),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }), flush=True)


if __name__ == "__main__":
    main()

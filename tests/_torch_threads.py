"""The one rule for the CPU threads of the port's tests, and the loop that
measures what its XLA warm-up is for.

Every ``tests/test_torch_*.py`` takes the autouse, module-scoped fixture
``worker_threads`` by one line,
``from _torch_threads import worker_threads  # noqa: F401``. For the
module's tests it

- runs torch's CPU ops on one thread, and gives the count it found back
  on teardown. A fit of a few hundred steps of small ops takes seconds on
  one thread, and minutes on torch's default pool of a thread per core
  while the suite's other workers hold the cores. On one thread torch's
  first float32 row sum in a process also takes the same order as every
  later one;
- warms XLA's threads before the module's comparisons with the JAX
  package. A float32 evaluation of the JAX package's ``pairwise_block``
  once came out up to 3.1e-4 from float64 in a six-worker run of the
  suite, and did not recur; the comparisons it could upset evaluate the
  JAX function in float64.

No other file under ``tests/`` sets torch's thread count, which
``tests/test_torch_threads.py`` checks. ``tests/test_torch_cuda.py`` is the
one port file without the fixture: it runs on the card under
``--noconftest``, where JAX is not installed, and on the CPU its tests
skip. A test that starts a Python child leaves the child on torch's
default threads.

Run as a script, it starts fresh processes on one torch thread, as a port
test runs, half of them with XLA's warm-up first, and counts those whose
first results leave float64 by more than 1e-5 relative (absolute below
1)::

    python tests/_torch_threads.py --procs 40 --parallel 6
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

LIMIT = 1e-5


def _warm_xla():
    import jax.numpy as jnp

    for _ in range(3):
        np.asarray(jnp.exp(jnp.ones((512, 512))) @ jnp.ones((512, 512)))


@pytest.fixture(scope="module", autouse=True)
def worker_threads():
    import torch

    _warm_xla()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clustered(n, d, seed, n_clusters=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(n_clusters, d))
    labels = rng.integers(0, n_clusters, n)
    return (centers[labels] + rng.normal(size=(n, d))).astype(np.float32)


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - want) / np.abs(want).clip(1.0)))


def _child(warm: bool) -> dict:
    """The first results of a fresh process on one torch thread against
    float64 numpy: the inputs and functions of
    ``test_pairwise_block_matches_jax`` and
    ``test_rowlse_matches_jax_xla_tier``."""
    import jax.numpy as jnp
    import torch

    from torchdr_tpu.ops.metrics import pairwise_block as jax_pairwise_block
    from torchdr_tpu.ops.reduce import pairwise_logkernel_rowlse as jax_rowlse
    from torchdr_tpu_torch.ops.metrics import pairwise_block
    from torchdr_tpu_torch.ops.reduce import pairwise_logkernel_rowlse

    torch.set_num_threads(1)
    if warm:
        _warm_xla()
    X, Y = _clustered(300, 32, seed=0), _clustered(200, 32, seed=1)
    dist64 = np.sqrt(((X.astype(np.float64)[:, None] - Y.astype(np.float64)[None]) ** 2).sum(-1))
    Z = (2.0 * np.random.default_rng(257).normal(size=(257, 2))).astype(np.float32)
    Z64 = Z.astype(np.float64)
    q = 1.0 / (1.0 + ((Z64[:, None] - Z64[None]) ** 2).sum(-1))
    np.fill_diagonal(q, 0.0)
    lse64 = np.log(q.sum(1))
    return {
        "torch_pairwise": _rel(
            pairwise_block(torch.from_numpy(X), torch.from_numpy(Y), "euclidean").numpy(), dist64
        ),
        "torch_rowlse": _rel(
            pairwise_logkernel_rowlse(torch.from_numpy(Z), "student", True, 64).numpy(), lse64
        ),
        "jax_pairwise": _rel(
            jax_pairwise_block(jnp.asarray(X), jnp.asarray(Y), "euclidean"), dist64
        ),
        "jax_rowlse": _rel(jax_rowlse(jnp.asarray(Z), "student", True, 64), lse64),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=40, help="fresh processes per condition")
    ap.add_argument("--parallel", type=int, default=6, help="processes run at once")
    ap.add_argument("--child", choices=["warm", "cold"], help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_child(args.child == "warm")))
        return
    jobs = ["warm", "cold"] * args.procs
    results = {"warm": [], "cold": []}
    for start in range(0, len(jobs), args.parallel):
        batch = jobs[start : start + args.parallel]
        running = [
            (kind, subprocess.Popen(
                [sys.executable, __file__, "--child", kind],
                stdout=subprocess.PIPE, text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"},
            ))
            for kind in batch
        ]
        for kind, p in running:
            out, _ = p.communicate()
            results[kind].append(json.loads(out.strip().splitlines()[-1]))
    for kind, rows in results.items():
        summary = {
            name: {
                "over_limit": sum(r[name] > LIMIT for r in rows),
                "worst": max(r[name] for r in rows),
            }
            for name in rows[0]
        }
        print(json.dumps({"condition": kind, "processes": len(rows), "limit": LIMIT, **summary}))


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    main()

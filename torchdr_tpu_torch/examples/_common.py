"""What the gallery's scripts share: the ``--device`` option, the mesh of
the distributed scripts, the gates, and the JAX package's numbers that some
gates compare with.

The JAX scripts assert nothing; the gates are set here. Every labelled fit
is held to a 10-NN label accuracy of its embedding (``eval.knn_label_accuracy``)
of at least ``MIN_ACC``, and every embedding to finite values. Scripts 3, 4,
5 and 8 are held to the JAX package's own results on the same data, read
from ``jax_reference.json``; ``tests/_examples_reference.py`` writes that
file by running the JAX scripts' code on the CPU at the runner's ``--fast``
sizes, and ``tests/test_torch_examples.py`` checks it against the JAX
package. Where the JAX script's own fit reads a 10-NN label accuracy
below 0.95 there, at the runner's ``--fast`` size or (``full_size``) at the
script's own, the gate at that size is that reading less 0.05
(:func:`accuracy_gate`); else it is ``MIN_ACC``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import time

import numpy as np
import torch

from ..base import resolve_device
from ..parallel.mesh import VIRTUAL_CPU_DEVICES_ENV, make_mesh

MIN_ACC = 0.9

REFERENCE = pathlib.Path(__file__).with_name("jax_reference.json")


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="auto",
                   help="'auto' (the card, or raise without one) or 'cpu'")
    return p


def jax_reference(script: str) -> dict:
    """The JAX package's results for ``script`` (e.g. "basics/incremental_pca")."""
    return json.loads(REFERENCE.read_text())[script]


def example_mesh(device: str):
    """The distributed scripts' mesh: every card when the machine has more
    than one, else four shards of the one card; on the CPU,
    ``VIRTUAL_CPU_DEVICES_ENV`` CPU devices (8 when unset, the JAX scripts'
    virtual device count)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return make_mesh(devices=["cpu"] * int(os.environ.get(VIRTUAL_CPU_DEVICES_ENV) or 8))
    if torch.cuda.device_count() > 1:
        return make_mesh(devices=[f"cuda:{i}" for i in range(torch.cuda.device_count())])
    return make_mesh(devices=[dev] * 4)


def timed_fit(model, X):
    """``model.fit_transform(X)`` of numpy rows and its seconds (the
    embedding comes back as numpy, so the card has finished)."""
    t0 = time.perf_counter()
    Z = np.asarray(model.fit_transform(X))
    return Z, time.perf_counter() - t0


def check_embedding(script: str, name: str, Z) -> None:
    if not np.all(np.isfinite(Z)):
        raise AssertionError(f"{script} {name}: the embedding has non-finite values")


def accuracy_gate(script: str, name: str, n: int) -> float:
    """The 10-NN accuracy gate of fit ``name`` of ``script`` on n rows: the
    JAX script's reading at the same size where the reference holds one
    (``full_size``), else at the runner's size, less 0.05 where it is below
    0.95; else ``MIN_ACC``."""
    ref = json.loads(REFERENCE.read_text()).get(script, {})
    full = ref.get("full_size", {})
    reading = full["fits"].get(name) if full.get("n") == n else None
    jax_acc = (reading or ref.get("fits", {}).get(name, {})).get("knn_acc", 1.0)
    return acc_gate(jax_acc)


def acc_gate(jax_acc: float) -> float:
    """The 10-NN accuracy gate of a fit whose JAX counterpart read
    ``jax_acc``: that reading less 0.05 where it is below 0.95, else
    ``MIN_ACC``."""
    return MIN_ACC if jax_acc >= 0.95 else jax_acc - 0.05


def check_fit(script: str, name: str, fit: dict) -> None:
    """A labelled fit: finite, and its 10-NN label accuracy at its gate."""
    check_embedding(script, name, fit["embedding"])
    gate = accuracy_gate(script, name, len(fit["labels"]))
    fit["gate"] = gate
    if not fit["knn_acc"] >= gate:
        raise AssertionError(
            f"{script} {name}: 10-NN label accuracy {fit['knn_acc']:.4f} < {gate:.4f}"
        )

"""What the gallery's CPU tests share: a script run in-process, and the
gates every labelled fit meets at the tests' sizes."""

import importlib

import numpy as np

from torchdr_tpu_torch.examples import _common
from torchdr_tpu_torch.examples.__main__ import module_name


def run(script, *argv):
    """The port's script on the CPU, in-process, on the threads that the
    calling module's ``_torch_threads`` fixture sets: one torch thread."""
    return importlib.import_module(module_name(script + ".py")).main(
        ["--device", "cpu", *argv])


def check_gates(out):
    """Every fit's embedding finite; every labelled fit's embedding of its
    labels' length, at the gallery's accuracy gate (0.9 at these sizes)."""
    for fit in out["fits"].values():
        assert np.all(np.isfinite(fit["embedding"]))
        if "labels" in fit:
            assert fit["embedding"].shape == (len(fit["labels"]), 2)
            assert fit["gate"] == _common.MIN_ACC and fit["knn_acc"] >= fit["gate"]

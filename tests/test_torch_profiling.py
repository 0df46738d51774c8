"""The port's profiling hooks (``utils/profiling.py``) and Poincaré-disk plot
(``utils/visu.py``) against the JAX package's.

``PhaseTimer.summary`` is the JAX package's string on the same timings;
``device_trace`` writes a Chrome trace of a small fit on the CPU (its
``device="auto"`` needs a card); ``plot_poincare_disk`` draws the same
scatter, circles and limits as the JAX function under matplotlib's Agg
backend, and refuses a Z that is not 2-D with the same message.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.utils.profiling import PhaseTimer as JaxPhaseTimer
from torchdr_tpu.utils.visu import plot_poincare_disk as jax_plot_poincare_disk
from torchdr_tpu_torch import PCA
from torchdr_tpu_torch.utils import PhaseTimer, device_trace, plot_poincare_disk


@pytest.mark.parametrize("timings", [
    {"knn": 1.25, "affinity": 0.5, "optimize": 3.0},
    {"one": 0.001},
    {"a": 1e-4, "b": 2.0, "c": 123.456789},
])
def test_phase_timer_summary_is_the_jax_packages(timings):
    port, ref = PhaseTimer(), JaxPhaseTimer()
    port.timings, ref.timings = dict(timings), dict(timings)
    assert port.summary() == ref.summary()


def test_phase_timer_accumulates_by_name():
    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase("a"):
            pass
    with timer.phase("b"):
        pass
    assert list(timer.timings) == ["a", "b"] and all(v >= 0 for v in timer.timings.values())
    assert timer.summary().startswith("a: ")


def _trace_events(logdir):
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_device_trace_on_the_cpu_records_the_fits_operations(tmp_path):
    X = np.random.default_rng(0).normal(size=(64, 5)).astype(np.float32)
    logdir = str(tmp_path / "trace")
    with device_trace(logdir, device="cpu") as out:
        assert out == logdir
        PCA(n_components=2, device="cpu").fit_transform(X)
    names = [e.get("name", "") for e in _trace_events(logdir)]
    assert any(n.startswith("aten::") for n in names)
    assert any("linalg" in n or "svd" in n for n in names)


def test_device_trace_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with device_trace(str(tmp_path / "t")):
            pass
    with pytest.raises(ValueError, match="'auto' or 'cpu'"):
        with device_trace(str(tmp_path / "t"), device="tpu"):
            pass
    assert not (tmp_path / "t").exists()


def _drawn(ax):
    coll = ax.collections[0]
    return {
        "offsets": np.asarray(coll.get_offsets()),
        "colors": np.asarray(coll.get_array()) if coll.get_array() is not None else None,
        "sizes": np.asarray(coll.get_sizes()),
        "circles": [(p.center, p.radius, p.get_fill(), p.get_facecolor(), p.get_edgecolor())
                    for p in ax.patches],
        "limits": (ax.get_xlim(), ax.get_ylim()),
        "aspect": ax.get_aspect(),
        "axis_on": ax.axison,
    }


@pytest.mark.parametrize("labels", [None, "labels"])
def test_plot_poincare_disk_draws_the_jax_packages_figure(labels):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(0)
    Z = rng.uniform(-0.7, 0.7, size=(40, 2)).astype(np.float32)
    y = rng.integers(0, 3, 40) if labels else None
    port_ax = plot_poincare_disk(torch.from_numpy(Z), labels=None if y is None
                                 else torch.from_numpy(y), s=5)
    ref_ax = jax_plot_poincare_disk(Z, labels=y, s=5)
    port, ref = _drawn(port_ax), _drawn(ref_ax)
    np.testing.assert_array_equal(port.pop("offsets"), ref.pop("offsets"))
    np.testing.assert_array_equal(port.pop("sizes"), ref.pop("sizes"))
    if y is None:
        assert port.pop("colors") is None and ref.pop("colors") is None
    else:
        np.testing.assert_array_equal(port.pop("colors"), ref.pop("colors"))
    assert str(port) == str(ref)
    plt.close("all")


def test_plot_poincare_disk_refuses_a_3d_embedding_as_the_jax_package_does():
    import matplotlib

    matplotlib.use("Agg")
    Z = np.zeros((5, 3), np.float32)
    with pytest.raises(ValueError) as ref:
        jax_plot_poincare_disk(Z)
    with pytest.raises(ValueError) as port:
        plot_poincare_disk(torch.from_numpy(Z))
    assert str(port.value) == str(ref.value)

"""The spans of a fit (``utils/profiling.py``): the keys of ``timings_``,
how children nest in their parents, the active record across fits, and
the profiler ranges that ``device_trace`` alone turns on.

Small UMAP and t-SNE fits on the CPU, one of each kind per module. The test
marked ``cuda`` runs on the card; this file imports neither JAX nor the JAX
package, so there:

    python -m pytest --noconftest -q tests/test_torch_tracing.py
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread
from torchdr_tpu_torch import IVF, PCA, TSNE, UMAP
from torchdr_tpu_torch.ops.ivf import ivf_knn
from torchdr_tpu_torch.parallel import make_mesh
from torchdr_tpu_torch.utils import device_trace, get_logger, log_phase
from torchdr_tpu_torch.utils import profiling

PHASES = {"knn", "affinity", "init", "optimize"}
API = {"fit", "api.check", "api.dedup", "api.h2d", "api.d2h"}
LOOP = {"optimize.consts", "optimize.loop", "optimize.wait"}
IVF_KEYS = {"knn.build", "knn.search"}
#: what a mesh adds: the IVF's build, copies and sharded search; the exchange
MESH_IVF_KEYS = {"knn.build", "knn.replicate", "knn.shards"}
MESH_KEYS = {"affinity.exchange"}
#: the accumulator: the sum of many blocks, not one range
TOTALS = {"optimize.wait"}
KINDS = ("umap", "umap_ivf", "tsne")


def _rows(n=500, d=12, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=8.0, size=(4, d))
    return (centers[rng.integers(0, 4, n)] + rng.normal(size=(n, d))).astype(np.float32)


def _model(kind, device="cpu"):
    if kind == "tsne":
        return TSNE(perplexity=10, max_iter=60, random_state=0, device=device)
    knn = IVF if kind == "umap_ivf" else "exact"
    return UMAP(n_neighbors=10, max_iter=60, random_state=0, knn_mode=knn, device=device)


@pytest.fixture(scope="module")
def fitted():
    X = _rows()
    models = {}
    for kind in KINDS:
        models[kind] = _model(kind)
        models[kind].fit_transform(X)
    return models


@pytest.mark.parametrize("kind", KINDS)
def test_a_fit_records_the_old_phases_and_every_span(fitted, kind):
    timings = fitted[kind].timings_
    assert PHASES <= set(timings)
    assert set(timings) == PHASES | API | LOOP | (IVF_KEYS if kind == "umap_ivf" else set())
    assert all(isinstance(v, float) and v >= 0 for v in timings.values())


@pytest.mark.parametrize("kind", KINDS)
def test_children_sum_to_no_more_than_their_parent(fitted, kind):
    t = fitted[kind].timings_
    api = sum(v for k, v in t.items() if k.startswith("api."))
    assert api + t["affinity"] + t["init"] + t["optimize"] <= t["fit"]
    assert t["knn"] <= t["affinity"]
    assert t["optimize.consts"] + t["optimize.loop"] <= t["optimize"]
    assert t["optimize.wait"] <= t["optimize.loop"]
    if kind == "umap_ivf":
        assert t["knn.build"] + t["knn.search"] <= t["knn"]


def test_a_span_on_a_mesh_synchronises_each_distinct_card(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: seen.append(device))
    mesh = make_mesh(devices=["cuda:0", "cuda:1", "cuda:0", "cpu", "cuda:3"])
    cards = [torch.device("cuda", i) for i in (0, 1, 3)]
    record = {}
    with profiling.fit_span(record):
        with profiling.span("knn", mesh=mesh):
            with profiling.span("shards", mesh=make_mesh(devices=["cpu"] * 4)):
                pass
            assert seen == []
        assert seen == cards
        with profiling.span("consts", torch.device("cuda", 2), mesh=mesh):
            pass
        assert seen == cards + [torch.device("cuda", 2)] + cards
        with profiling.span("loop", torch.device("cuda", 1)):
            pass
    assert seen[-1] == torch.device("cuda", 1) and len(seen) == 8
    assert set(record) == {"fit", "knn", "knn.shards", "consts", "loop"}


@pytest.mark.parametrize("knn", ["exact", "ivf"])
def test_a_mesh_fit_records_the_mesh_s_spans_and_every_other(knn):
    """A UMAP fit over a 4-way CPU mesh holds every key a one-device fit
    holds but "knn.search" (the mesh's search is "knn.shards"), and those
    the mesh adds."""
    kind = "umap_ivf" if knn == "ivf" else "umap"
    model = _model(kind)
    model.mesh = make_mesh(devices=["cpu"] * 4)
    with one_torch_thread():
        model.fit_transform(_rows())
    added = MESH_KEYS | (MESH_IVF_KEYS if knn == "ivf" else set())
    assert set(model.timings_) == PHASES | API | LOOP | added
    t = model.timings_
    assert t["affinity.exchange"] <= t["affinity"] - t["knn"]
    if knn == "ivf":
        assert t["knn.build"] + t["knn.replicate"] + t["knn.shards"] <= t["knn"]


def test_the_active_record_is_restored_after_a_fit_that_raises():
    X = _rows(n=200)
    X[3, 2] = np.nan
    outer = {}
    with profiling.fit_span(outer):
        model = _model("umap")
        with pytest.raises(ValueError, match="NaN"):
            model.fit_transform(X)
        assert profiling._ACTIVE.get() == (outer, "")
        with profiling.span("after"):
            pass
    assert profiling._ACTIVE.get() is None
    assert set(outer) == {"fit", "after"}
    assert set(model.timings_) == {"fit", "api.check"}


def test_a_fit_inside_a_fit_keeps_its_own_record():
    inner = PCA(n_components=2, device="cpu")

    class Nested(UMAP):
        def on_affinity_computation_end(self):
            super().on_affinity_computation_end()
            inner.fit_transform(np.asarray(self.affinity_in_[:, :5]))

    model = Nested(n_neighbors=10, max_iter=20, random_state=0, device="cpu")
    model.fit_transform(_rows(n=300))
    assert {"fit", "api.check", "api.h2d", "api.d2h"} <= set(inner.timings_) <= API
    assert set(model.timings_) == PHASES | API | LOOP
    assert inner.timings_["fit"] <= model.timings_["affinity"] - model.timings_["knn"]


def test_outside_a_fit_spans_record_nothing_and_phases_record_where_told():
    assert profiling.span("x") is profiling.span_total("y")  # the shared no-op
    record = {}
    with log_phase(get_logger("test"), "phase", record):
        with profiling.span("child"):
            pass
    assert set(record) == {"phase"}
    X = torch.from_numpy(_rows(n=600))
    dists, ids = ivf_knn(X, k=5, generator=torch.Generator().manual_seed(0))
    assert ids.shape == (600, 5) and profiling._ACTIVE.get() is None


def test_a_plain_profiler_sees_no_span():
    model = _model("umap_ivf")
    with torch.profiler.profile() as prof:
        model.fit_transform(_rows(n=300))
    assert not [e.name for e in prof.events() if e.name.startswith("torchdr/")]


def _trace_events(logdir):
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def _span_events(logdir):
    """Each ``torchdr/<span>`` range of the trace: name -> [seconds]."""
    out = {}
    for e in _trace_events(logdir):
        if e.get("name", "").startswith("torchdr/") and e.get("ph") == "X":
            out.setdefault(e["name"][len("torchdr/"):], []).append(e["dur"] / 1e6)
    return out


def test_device_trace_holds_each_span_with_its_timing(tmp_path):
    model = _model("umap_ivf")
    logdir = str(tmp_path / "trace")
    with device_trace(logdir, device="cpu"):
        model.fit_transform(_rows(n=600))
    assert not profiling._annotate
    ranges = _span_events(logdir)
    assert set(ranges) == set(model.timings_)
    for name, seconds in model.timings_.items():
        if name in TOTALS:  # each block's range holds its own enter and exit
            assert abs(sum(ranges[name]) - seconds) <= 1e-3 * len(ranges[name])
        else:
            assert len(ranges[name]) == 1 and abs(ranges[name][0] - seconds) <= 1e-3, name


@pytest.mark.cuda
def test_on_the_card_spans_reach_device_trace_alone(tmp_path):
    """Under the benchmark's profiler (CPU and CUDA) a fit yields no
    device-typed user annotation, which a reading of busy time would count;
    under ``device_trace`` its spans appear, the kernels beside them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: traces the card")
    from torch.profiler import ProfilerActivity, profile

    X = _rows(n=2000, d=16)
    model = _model("umap_ivf", device="cuda")
    model.fit_transform(X)  # loads the kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.fit_transform(X)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    assert any(str(e.device_type()).endswith("CUDA") for e in events)
    assert not [e.name() for e in events if e.name().startswith("torchdr/")]
    assert not [e.name() for e in events
                if str(e.device_type()).endswith("CUDA") and e.is_user_annotation()]

    logdir = str(tmp_path / "trace")
    with device_trace(logdir):
        model.fit_transform(X)
    ranges = _span_events(logdir)
    assert set(model.timings_) <= set(ranges)
    kernels = [e for e in _trace_events(logdir) if e.get("cat") == "kernel"]
    assert kernels

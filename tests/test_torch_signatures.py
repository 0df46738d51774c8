"""The port's public signatures against the JAX package's.

One case per public function, and per constructor and public method of a
public class, of the nine subpackages' ``__all__``: the port's parameters
must carry the JAX package's names, in its order, with its defaults and
kinds. The only differences allowed are the port's documented extras,
each listed below beside the ROADMAP queue-3 line that justifies it, and
``key`` (a JAX PRNG key) replaced by ``generator`` (a ``torch.Generator``)
in the same place, defaulting to None. No fit runs.
"""

import importlib
import inspect

import pytest

from _torch_threads import worker_threads  # noqa: F401

MODULES = ["", ".ops", ".utils", ".parallel", ".eval", ".affinity", ".models",
           ".models.neighbor", ".models.spectral"]

# Extra parameters of the port, anywhere they appear, each with its ROADMAP
# queue-3 deviation.
EXTRAS = {
    "device": "the eval functions take device; device_trace takes device; the root "
              "searches take a tensor bound's device, else device='auto'",
    "generator": "random draws differ between the two frameworks: every function that "
                 "draws takes a torch.Generator or the draw itself",
    "init_centers": "random draws of the batch builds and PQ: pq_train draws its "
                    "seedings from one generator (init_centers takes them)",
    "train_idx": "the kNN tier: builds are compared from the JAX package's draws "
                 "(train_idx, init_centers, super_init)",
    "train_rows": "random draws of the batch builds: train_rows takes a given sample",
    "super_init": "the kNN tier: builds take the JAX package's supers draw",
    "sync_every": "solvers that stop on a tolerance test it every 8 iterations",
    "timings": "knn_graph_streaming reports its build, query and merge seconds into "
               "a timings dict",
    "row_offset": "a mesh is one process's ordered tuple of devices: a shard's kNN "
                  "block takes its rows' offset",
    "devices": "a mesh is one process's ordered tuple of devices, repeats allowed",
}
# Extras of one callable only.
OWN_EXTRAS = {
    "KernelPCA.__init__": {"tol": "KernelPCA takes tol, which the JAX package's lacks"},
    "log_phase": {"record": "a phase's seconds go into a fit's timings_ (the parts "
                            "timed on the card, synchronised at each phase end)"},
}
# Parameters of the JAX callable that the port leaves out.
DROPPED = {
    "MLP.__init__": {"parent": "flax's Module bookkeeping; a torch.nn.Module has none",
                     "name": "the same"},
}
# Names the port replaces on purpose, with other signatures; their
# counterparts are held by test_torch_umap.py::test_exports_match_the_jax_package.
REPLACED = {"to_jax", "compile_cache_dir", "enable_compile_cache", "row_sharding", "replicated"}
# Methods the port names otherwise: a torch.nn.Module's call is its forward.
RENAMED = {"MLP.__call__": "forward"}
# Defaults that differ on purpose.
DEFAULTS = {
    "device_trace": {"logdir": "device_trace writes a torch.profiler trace, into a "
                               "directory of its own"},
}


def _public(mod):
    """``__all__``, or where a module has none (``utils``), its public
    attributes that are not modules."""
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)]


def _own_methods(cls):
    """``__init__``, ``__call__`` and the public methods that classes of the
    JAX package define along ``cls``'s MRO (not flax's or object's)."""
    names = set()
    for klass in cls.__mro__:
        if not klass.__module__.startswith("torchdr_tpu."):
            continue
        for name, value in vars(klass).items():
            fn = value.__func__ if isinstance(value, (staticmethod, classmethod)) else value
            if (name in ("__init__", "__call__") or not name.startswith("_")) and callable(fn):
                names.add(name)
    return sorted(names)


def _cases():
    cases, seen = [], set()
    for sub in MODULES:
        jax_mod = importlib.import_module("torchdr_tpu" + sub)
        for name in _public(jax_mod):
            if name in REPLACED:
                continue
            obj = getattr(jax_mod, name)
            if inspect.isclass(obj):
                for meth in _own_methods(obj):
                    label = f"{name}.{meth}"
                    if label not in seen:
                        seen.add(label)
                        cases.append((sub, name, meth))
            elif callable(obj) and name not in seen:
                seen.add(name)
                cases.append((sub, name, None))
    return cases


def _resolve(package, sub, name, meth):
    obj = getattr(importlib.import_module(package + sub), name)
    if meth is not None and package == "torchdr_tpu_torch":
        meth = RENAMED.get(f"{name}.{meth}", meth)
    return obj if meth is None else getattr(obj, meth)


def _norm_default(value):
    """A dtype default by its name (``jnp.float32`` and ``torch.float32`` are
    the same float32); anything else as it is."""
    if value is inspect.Parameter.empty:
        return value
    name = getattr(value, "__name__", None) or str(value)
    if name in ("float32", "torch.float32", "float64", "torch.float64"):
        return name.replace("torch.", "")
    return value


def _expected_port_params(label, jax_params):
    """The port's parameters as (name, kind, default) that the JAX
    package's imply: ``key`` becomes ``generator`` (default None), dropped
    parameters go."""
    out = []
    for p in jax_params:
        if p.name in DROPPED.get(label, {}):
            continue
        if p.name == "key":
            out.append(("generator", p.kind, None))
        else:
            out.append((p.name, p.kind, _norm_default(p.default)))
    return out


CASES = _cases()


@pytest.mark.parametrize("sub,name,meth", CASES,
                         ids=[f"{s or '.'}:{n}{'.' + m if m else ''}" for s, n, m in CASES])
def test_port_signature_matches_the_jax_package(sub, name, meth):
    label = name if meth is None else f"{name}.{meth}"
    jax_fn = _resolve("torchdr_tpu", sub, name, meth)
    port_fn = _resolve("torchdr_tpu_torch", sub, name, meth)
    jax_params = list(inspect.signature(jax_fn).parameters.values())
    port_params = list(inspect.signature(port_fn).parameters.values())
    allowed = {**EXTRAS, **OWN_EXTRAS.get(label, {})}
    want = _expected_port_params(label, jax_params)
    want_names = {w[0] for w in want}
    extras = [p.name for p in port_params if p.name not in want_names]
    assert not [e for e in extras if e not in allowed], (label, extras)
    got = [(p.name, p.kind, _norm_default(p.default))
           for p in port_params if p.name in want_names]
    for (w_name, w_kind, w_default), (g_name, g_kind, g_default) in zip(want, got):
        assert (g_name, g_kind) == (w_name, w_kind), (label, want, got)
        if w_name in DEFAULTS.get(label, {}):
            continue
        assert g_default == w_default or (g_default is w_default), (label, w_name,
                                                                    w_default, g_default)
    assert [g[0] for g in got] == [w[0] for w in want], (label, want, got)


def test_every_allowance_is_used():
    """Each extra, dropped parameter and default in the lists above appears
    in some case, so the lists hold nothing stale."""
    used_extras, used_own, used_dropped, used_defaults = set(), set(), set(), set()
    for sub, name, meth in CASES:
        label = name if meth is None else f"{name}.{meth}"
        jax_names = set(inspect.signature(_resolve("torchdr_tpu", sub, name, meth)).parameters)
        port_sig = inspect.signature(_resolve("torchdr_tpu_torch", sub, name, meth))
        for pname, p in port_sig.parameters.items():
            if pname not in jax_names:
                if pname in OWN_EXTRAS.get(label, {}):
                    used_own.add((label, pname))
                elif pname in EXTRAS and not (pname == "generator" and "key" in jax_names):
                    used_extras.add(pname)
        used_dropped |= {(label, n) for n in DROPPED.get(label, {}) if n in jax_names}
        used_defaults |= {(label, n) for n in DEFAULTS.get(label, {})
                          if port_sig.parameters[n].default
                          != inspect.signature(_resolve("torchdr_tpu", sub, name, meth))
                          .parameters[n].default}
    # generator also replaces key, which the comparison itself checks
    assert set(EXTRAS) - {"generator"} <= used_extras
    assert used_own == {(label, n) for label, d in OWN_EXTRAS.items() for n in d}
    assert used_dropped == {(label, n) for label, d in DROPPED.items() for n in d}
    assert used_defaults == {(label, n) for label, d in DEFAULTS.items() for n in d}


def test_neighbor_embedding_params_are_the_jax_package_s():
    """``NeighborEmbedding`` takes ``affinity_out`` and ``kwargs_affinity_out``
    in the JAX package's places, so ``get_params()`` lists them, a second
    positional argument is ``affinity_out``, and ``set_params`` takes it."""
    from torchdr_tpu.affinity import EntropicAffinity as JaxEntropicAffinity
    from torchdr_tpu.models.neighbor.base import NeighborEmbedding as JaxNeighborEmbedding
    from torchdr_tpu_torch.affinity import EntropicAffinity, NormalizedStudentAffinity
    from torchdr_tpu_torch.models.neighbor.base import NeighborEmbedding

    jax_model = JaxNeighborEmbedding(JaxEntropicAffinity(perplexity=5))
    port = NeighborEmbedding(EntropicAffinity(perplexity=5, device="cpu"), device="cpu")
    assert sorted(port.get_params()) == sorted(jax_model.get_params())
    assert port.get_params()["affinity_out"] is None
    out = NormalizedStudentAffinity(device="cpu")
    second = NeighborEmbedding(EntropicAffinity(perplexity=5, device="cpu"), out, device="cpu")
    assert second.affinity_out is out and second.n_components == 2
    port.set_params(affinity_out=out, kwargs_affinity_out={"log": True})
    assert port.affinity_out is out and port.kwargs_affinity_out == {"log": True}
    assert "affinity_out=" in repr(port)

"""LargeVis and InfoTSNE of the PyTorch port against the JAX package.

Both packages start from the JAX package's pre-loop state (entropic
affinity, kNN indices, PCA init, exclusion sets) and take the draws the
JAX package makes from its keys: the shared negative sample
(``randint(key, (S,), 0, n)``) or the per-point uniform draw
(``uniform(key, (n, n_negatives))``). Tolerances, those of the t-SNE
slice's parity tests (``tests/test_torch_tsne.py``):

- one step: the loss at 1e-5 relative, the gradient and the updated
  embedding at 1e-5 absolute, against the JAX package in float32 and
  evaluated in float64 on the same inputs and draws;
- a short run of the loop (10 steps, through InfoTSNE's early-
  exaggeration switch): 1e-5 absolute on the embedding;
- a small full fit: silhouette above the floor of
  ``tests/test_neighbor_embedding.py`` (0.15) and within 0.1 of the JAX
  fit's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.eval import silhouette_score
from torchdr_tpu.models.neighbor.largevis import InfoTSNE as JaxInfoTSNE
from torchdr_tpu.models.neighbor.largevis import LargeVis as JaxLargeVis
from torchdr_tpu.utils.optim import make_optimizer as jax_make_optimizer
from torchdr_tpu_torch import InfoTSNE, KnnConfig, LargeVis
from torchdr_tpu_torch.utils.interop import load_reference_state
from torchdr_tpu_torch.utils.optim import make_optimizer

MODELS = {"LargeVis": (JaxLargeVis, LargeVis), "InfoTSNE": (JaxInfoTSNE, InfoTSNE)}


def _blobs(n=300, d=16, n_clusters=4, seed=0, scale=6.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(n_clusters, d))
    labels = rng.integers(0, n_clusters, n)
    return (centers[labels] + rng.normal(size=(n, d))).astype(np.float32), labels


def _to_f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a,
        tree,
    )


def _pre_loop_state(model, kw, seed=4):
    jax_cls, port_cls = MODELS[model]
    X, _ = _blobs(seed=seed)
    Xj = jnp.asarray(X)
    jm = jax_cls(**kw)
    jm.n_samples_in_, jm.n_features_in_ = X.shape
    jm._fit_mesh_ = None
    jm._compute_input_affinity(Xj)
    jm.on_affinity_computation_end()
    arrays = {
        "affinity_in": np.asarray(jm.affinity_in_),
        "NN_indices": np.asarray(jm.NN_indices_),
        "init_embedding": np.array(jm._init_embedding(Xj)),
        "neg_exclusion": np.asarray(jm.neg_exclusion_),
        "neg_valid_counts": np.asarray(jm.neg_valid_counts_),
    }
    tm = port_cls(device="cpu", **kw)
    load_reference_state(tm, arrays)
    return jm, jm._build_consts(Xj), tm, tm._build_consts(None), arrays


def _jax_draw(jm, key, n):
    """The draw the JAX package's repulsion makes from ``key``, as numpy,
    in the current precision mode."""
    if jm.shared_negatives:
        return {"neg_ids": np.asarray(jax.random.randint(key, (jm._shared_negative_count(n),),
                                                         0, n))}
    return {"u": np.asarray(jax.random.uniform(key, (n, jm.n_negatives)))}


def _port_draw(draw):
    return {k: torch.from_numpy(v).long() if k == "neg_ids" else torch.from_numpy(v)
            for k, v in draw.items()}


def _port_loss_and_grad(tm, tconsts, Z, it, coeff, draw):
    Zg = torch.from_numpy(Z).requires_grad_(True)
    attr, _ = tm._attractive_loss(Zg, tconsts, {}, it)
    rep, _ = tm._repulsive_loss(Zg, tconsts, {}, it, **_port_draw(draw))
    loss = coeff * attr + tm.repulsion_strength * rep
    (grad,) = torch.autograd.grad(loss, Zg)
    return float(loss), grad


CASES = [
    ("LargeVis", True, 0), ("LargeVis", True, 7), ("LargeVis", False, 0), ("LargeVis", False, 5),
    ("InfoTSNE", True, 0), ("InfoTSNE", True, 6), ("InfoTSNE", False, 5), ("InfoTSNE", False, 40),
]


@pytest.mark.parametrize("model, shared, it", CASES)
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "in_float64"])
def test_one_step_matches_jax(model, shared, it, x64):
    """One step from the JAX package's pre-loop state, on the JAX draw:
    shared and per-point negatives; InfoTSNE's early exaggeration ends
    after step 5, so step 6 takes the moment reset."""
    ee_iter = 5
    kw = dict(perplexity=10, max_iter=60, random_state=0, shared_negatives=shared)
    if model == "InfoTSNE":
        kw.update(early_exaggeration_iter=ee_iter, n_negatives=30)
    jm, jconsts, tm, tconsts, arrays = _pre_loop_state(model, kw)
    n = arrays["affinity_in"].shape[0]
    rng = np.random.default_rng(it)
    if it == 0:
        Z, buf = arrays["init_embedding"], None
    else:
        Z = rng.normal(size=(n, 2)).astype(np.float32)
        buf = (1e-3 * rng.normal(size=(n, 2))).astype(np.float32)
    schedule = tm._make_schedule()
    coeff, lr_t, hyper = schedule(it)
    key = jax.random.PRNGKey(it)

    jopt = jax_make_optimizer("SGD")
    dt = jnp.float64 if x64 else jnp.float32
    with jax.enable_x64(x64):
        draw = _jax_draw(jm, key, n)
        consts = _to_f64(jconsts) if x64 else jconsts
        Zj = jnp.asarray(Z, dt)
        state = jopt.init(Zj)
        if buf is not None:
            state = {**state, "buf": jnp.asarray(buf, dt), "step": jnp.asarray(3)}
        if model == "InfoTSNE" and it == ee_iter + 1:
            state = jopt.reset(state)
        w_loss, w_grad = jax.value_and_grad(
            lambda v: jm._loss(v, consts, {}, it, key, coeff)[0])(Zj)
        w_Z, _ = jopt.update(w_grad, state, Zj, lr_t, hyper)
        w_loss, w_grad, w_Z = float(w_loss), np.asarray(w_grad), np.asarray(w_Z)
    assert w_grad.dtype == (np.float64 if x64 else np.float32)

    g_loss, g_grad = _port_loss_and_grad(tm, tconsts, Z, it, coeff, draw)
    opt = make_optimizer("SGD")
    state = opt.init(torch.from_numpy(Z)) if buf is None else {"buf": torch.from_numpy(buf),
                                                               "step": 3}
    if model == "InfoTSNE" and it == ee_iter + 1:
        state = opt.reset(state)
    g_Z, _ = opt.update(g_grad, state, torch.from_numpy(Z), lr_t, hyper)

    in_ee = model == "InfoTSNE" and it <= ee_iter
    assert coeff == (12.0 if in_ee else 1.0)
    np.testing.assert_allclose(g_loss, w_loss, rtol=1e-5)
    np.testing.assert_allclose(g_grad.numpy(), w_grad, atol=1e-5, rtol=0)
    np.testing.assert_allclose(g_Z.numpy(), w_Z, atol=1e-5, rtol=0)


def _jax_step_keys(seed, steps):
    """The sub-key of each step of the JAX loop: ``key, sub = split(key)``."""
    key, subs = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def _feed_jax_draws(tm, draws):
    """Make the port's samplers hand out the JAX loop's draws, in order."""
    queue = list(draws)
    draw_shared, sample = tm._draw_shared_negatives, tm._sample_negatives
    tm._draw_shared_negatives = lambda n, S, device: torch.from_numpy(
        queue.pop(0)["neg_ids"]).long()
    tm._sample_negatives = lambda consts, u=None: sample(
        consts, u=torch.from_numpy(queue.pop(0)["u"]) if u is None else u)
    return queue, (draw_shared, sample)


@pytest.mark.parametrize("model, shared", [("LargeVis", True), ("LargeVis", False),
                                           ("InfoTSNE", True), ("InfoTSNE", False)])
def test_short_run_of_the_loop_matches_jax(model, shared):
    """The port's ``_optimize`` against the JAX package's over 10 steps from
    the same pre-loop state, each step on the JAX loop's draw (LinearLR for
    LargeVis; InfoTSNE's early exaggeration ends after step 3)."""
    kw = dict(perplexity=10, max_iter=10, random_state=0, shared_negatives=shared)
    if model == "InfoTSNE":
        kw.update(early_exaggeration_iter=3, n_negatives=30)
    jm, jconsts, tm, tconsts, arrays = _pre_loop_state(model, kw, seed=5)
    n = arrays["affinity_in"].shape[0]
    queue, _ = _feed_jax_draws(tm, [_jax_draw(jm, k, n) for k in _jax_step_keys(0, 10)])
    Z0 = arrays["init_embedding"]
    w_Z, w_it, _ = jm._optimize(jnp.asarray(Z0), jconsts, {})
    g_Z, g_it, _ = tm._optimize(torch.from_numpy(Z0.copy()), tconsts, {})
    assert int(w_it) == g_it == 10 and not queue
    np.testing.assert_allclose(g_Z.numpy(), np.asarray(w_Z), atol=1e-5, rtol=0)


@pytest.mark.parametrize("model", ["LargeVis", "InfoTSNE"])
def test_moons_quality(model, toy_moons):
    """``tests/test_neighbor_embedding.py``'s fits on two-moons, on the port:
    silhouette above 0.15 and within 0.1 of the JAX package's."""
    X, y = toy_moons
    kw = dict(perplexity=15, max_iter=500, random_state=0)
    if model == "InfoTSNE":
        kw["n_negatives"] = 50
    jax_cls, port_cls = MODELS[model]
    Z = port_cls(device="cpu", **kw).fit_transform(X)
    assert Z.shape == (100, 2) and np.isfinite(Z).all()
    s_port = float(silhouette_score(Z, y))
    s_jax = float(silhouette_score(np.asarray(jax_cls(**kw).fit_transform(X)), y))
    assert s_port > 0.15
    assert abs(s_port - s_jax) <= 0.1


@pytest.mark.parametrize("model", ["LargeVis", "InfoTSNE"])
def test_knn_mode_reaches_the_affinity(model):
    """``knn_mode`` (here the IVF tier) reaches the entropic affinity, as
    in the JAX package (``tests/test_neighbor_embedding.py``)."""
    X, _ = _blobs(n=800, seed=9)
    m = MODELS[model][1](perplexity=10, max_iter=20, random_state=0, device="cpu",
                         knn_mode=KnnConfig(mode="ivf", nprobe=8, n_clusters=16))
    assert m.affinity_in.knn_mode == "ivf"
    Z = m.fit_transform(X)
    assert Z.shape == (800, 2) and np.isfinite(Z).all()
    assert "knn" in m.timings_


@pytest.mark.parametrize("model", ["LargeVis", "InfoTSNE"])
def test_device_auto_without_cuda_raises(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='auto' resolves to it")
    X, _ = _blobs(n=100, seed=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        MODELS[model][1](perplexity=10, max_iter=5).fit_transform(X)


def test_params_follow_the_jax_defaults():
    for model, (jax_cls, port_cls) in MODELS.items():
        jm, tm = jax_cls(), port_cls(device="cpu")
        for name in ("perplexity", "lr", "optimizer", "optimizer_kwargs", "scheduler",
                     "scheduler_kwargs", "max_iter", "n_negatives", "early_exaggeration_coeff",
                     "early_exaggeration_iter", "min_grad_norm", "shared_negatives",
                     "n_shared_negatives", "discard_NNs", "metric", "max_iter_affinity",
                     "init", "init_scaling", "check_interval"):
            assert getattr(tm, name) == getattr(jm, name), (model, name)

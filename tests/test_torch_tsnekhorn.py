"""TSNEkhorn of the PyTorch port against the JAX package.

Both packages start from the JAX package's pre-loop state: its symmetric
entropic affinity (or, with ``symmetric_affinity=False``, its sparse
entropic affinity, which both densify) and its PCA init. Tolerances, those
of the t-SNE slice's parity tests (``tests/test_torch_tsne.py``):

- one step of the loss (5 warm-started Sinkhorn steps, with ``unrolling``
  on and off): the loss at 1e-5 relative, the gradient, the carried dual
  and the updated embedding at 1e-5 absolute, against the JAX package in
  float32 and evaluated in float64 on the same inputs;
- a short run of the loop (10 steps): 1e-5 absolute on the embedding;
- two-moons fits: the JAX package's tests on the port, silhouette above
  0.15 and within 0.1 of the JAX fit's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread, warm_worker_threads  # noqa: F401
from torchdr_tpu.eval import silhouette_score
from torchdr_tpu.models.neighbor.tsnekhorn import TSNEkhorn as JaxTSNEkhorn
from torchdr_tpu.utils.optim import make_optimizer as jax_make_optimizer
from torchdr_tpu_torch import TSNEkhorn
from torchdr_tpu_torch.utils.interop import load_reference_state
from torchdr_tpu_torch.utils.optim import make_optimizer


def _blobs(n=150, d=12, n_clusters=3, seed=0, scale=6.0):
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


def _pre_loop_state(kw, seed=4):
    X, _ = _blobs(seed=seed)
    Xj = jnp.asarray(X)
    jm = JaxTSNEkhorn(**kw)
    jm.n_samples_in_, jm.n_features_in_ = X.shape
    jm._fit_mesh_ = None
    jm._compute_input_affinity(Xj)
    jm.on_affinity_computation_end()
    arrays = {
        "affinity_in": np.asarray(jm.affinity_in_),
        "NN_indices": None if jm.NN_indices_ is None else np.asarray(jm.NN_indices_),
        "init_embedding": np.array(jm._init_embedding(Xj)),
    }
    tm = TSNEkhorn(device="cpu", **kw)
    load_reference_state(tm, arrays)
    return jm, jm._build_consts(Xj), tm, tm._build_consts(None), arrays


VARIANTS = {
    "default": dict(),
    "unrolling": dict(unrolling=True),
    "entropic": dict(symmetric_affinity=False),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("start", ["init", "spread"])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "in_float64"])
def test_one_step_matches_jax(variant, start, x64):
    """One step: at the PCA init from a zero dual, and from a spread
    embedding with a warm dual and a momentum buffer."""
    kw = dict(perplexity=10, max_iter=20, random_state=0, **VARIANTS[variant])
    jm, jconsts, tm, tconsts, arrays = _pre_loop_state(kw)
    n = arrays["init_embedding"].shape[0]
    assert tconsts["P"].shape == (n, n)
    rng = np.random.default_rng(7)
    if start == "init":
        Z, buf = arrays["init_embedding"], None
        dual = np.zeros(n, np.float32)
    else:
        Z = (2.0 * rng.normal(size=(n, 2))).astype(np.float32)
        buf = (1e-3 * rng.normal(size=(n, 2))).astype(np.float32)
        dual = (0.3 * rng.normal(size=n)).astype(np.float32)
    it = 0 if start == "init" else 7
    coeff, lr_t, hyper = tm._make_schedule()(it)
    assert coeff == 1.0 and hyper == {"momentum": 0.8}
    key = jax.random.PRNGKey(it)

    jopt = jax_make_optimizer("SGD")
    dt = jnp.float64 if x64 else jnp.float32
    with jax.enable_x64(x64):
        consts = _to_f64(jconsts) if x64 else jconsts
        Zj = jnp.asarray(Z, dt)
        carry = {"sinkhorn_dual": jnp.asarray(dual, dt)}
        (w_loss, w_carry), w_grad = jax.value_and_grad(
            lambda v: jm._loss(v, consts, carry, it, key, coeff), has_aux=True)(Zj)
        state = jopt.init(Zj)
        if buf is not None:
            state = {**state, "buf": jnp.asarray(buf, dt), "step": jnp.asarray(3)}
        w_Z, _ = jopt.update(w_grad, state, Zj, lr_t, hyper)
        w_loss, w_grad, w_Z = float(w_loss), np.asarray(w_grad), np.asarray(w_Z)
        w_dual = np.asarray(w_carry["sinkhorn_dual"])
    assert w_grad.dtype == (np.float64 if x64 else np.float32)

    Zg = torch.from_numpy(Z).requires_grad_(True)
    loss, g_carry = tm._loss(Zg, tconsts, {"sinkhorn_dual": torch.from_numpy(dual)}, it, coeff)
    (g_grad,) = torch.autograd.grad(loss, Zg)
    opt = make_optimizer("SGD")
    state = opt.init(Zg.detach()) if buf is None else {"buf": torch.from_numpy(buf), "step": 3}
    g_Z, _ = opt.update(g_grad, state, Zg.detach(), lr_t, hyper)

    np.testing.assert_allclose(float(loss), w_loss, rtol=1e-5)
    np.testing.assert_allclose(g_grad.numpy(), w_grad, atol=1e-5, rtol=0)
    np.testing.assert_allclose(g_carry["sinkhorn_dual"].numpy(), w_dual, atol=1e-5, rtol=0)
    np.testing.assert_allclose(g_Z.numpy(), w_Z, atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_short_run_of_the_loop_matches_jax(variant):
    """``_optimize`` of both packages over 10 steps from the same pre-loop
    state and a spread start (at the PCA init the default min_grad_norm
    stops both after the first step: :func:`test_default_stops_after_one_step`),
    the Sinkhorn dual carried from step to step."""
    kw = dict(perplexity=10, max_iter=10, random_state=0, lr=10.0, **VARIANTS[variant])
    jm, jconsts, tm, tconsts, arrays = _pre_loop_state(kw, seed=5)
    Z0 = (2.0 * np.random.default_rng(1).normal(size=(150, 2))).astype(np.float32)
    w_Z, w_it, _ = jm._optimize(jnp.asarray(Z0), jconsts, jm._init_carry(jconsts))
    g_Z, g_it, _ = tm._optimize(torch.from_numpy(Z0.copy()), tconsts, tm._init_carry(tconsts))
    assert int(w_it) == g_it == 10
    np.testing.assert_allclose(g_Z.numpy(), np.asarray(w_Z), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm._final_carry_["sinkhorn_dual"].numpy(),
                               np.asarray(jm._final_carry_["sinkhorn_dual"]), atol=1e-5, rtol=0)


def test_default_stops_after_one_step(toy_moons):
    """A quirk of the reference, copied: the default min_grad_norm (1e-4)
    lies above the gradient's norm at the PCA init scaled to 1e-4, so both
    packages stop at the first convergence check, after one step."""
    X, _ = toy_moons
    kw = dict(perplexity=15, max_iter=300, lr=1e-1, random_state=0)
    jm, tm = JaxTSNEkhorn(**kw), TSNEkhorn(device="cpu", **kw)
    jm.fit_transform(X)
    tm.fit_transform(X)
    assert tm.n_iter_ == jm.n_iter_ == 1
    assert tm._last_grad_norm_ < 1e-4
    np.testing.assert_allclose(tm._last_grad_norm_, jm._last_grad_norm_, rtol=1e-4)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moons_quality(variant, toy_moons):
    """``tests/test_neighbor_embedding.py::TestTSNEkhorn`` on the port (its
    quality fit, its unrolling and entropic-affinity variants), with the
    silhouette above 0.15 and within 0.1 of the JAX package's."""
    X, y = toy_moons
    kw = dict(perplexity=15, max_iter=300 if variant == "default" else 50, lr=1e-1,
              random_state=0, **VARIANTS[variant])
    with one_torch_thread():
        Z = TSNEkhorn(device="cpu", **kw).fit_transform(X)
    assert Z.shape == (100, 2) and np.isfinite(Z).all()
    s_port = float(silhouette_score(Z, y))
    assert s_port > 0.15
    s_jax = float(silhouette_score(np.asarray(JaxTSNEkhorn(**kw).fit_transform(X)), y))
    assert abs(s_port - s_jax) <= 0.1


def test_device_auto_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='auto' resolves to it")
    X, _ = _blobs(n=60, seed=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSNEkhorn(perplexity=5, max_iter=5).fit_transform(X)


def test_params_follow_the_jax_defaults():
    jm, tm = JaxTSNEkhorn(), TSNEkhorn(device="cpu")
    for name in ("perplexity", "lr", "optimizer", "optimizer_kwargs", "scheduler", "max_iter",
                 "min_grad_norm", "init", "init_scaling", "lr_affinity_in",
                 "eps_square_affinity_in", "tol_affinity_in", "max_iter_affinity_in", "metric",
                 "unrolling", "symmetric_affinity", "sinkhorn_iter", "check_interval"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert type(tm.affinity_in).__name__ == type(jm.affinity_in).__name__
    assert tm.affinity_in.zero_diag is jm.affinity_in.zero_diag is False

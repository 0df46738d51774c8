"""PACMAP and PACMAPAffinity of the PyTorch port against the JAX package.

The affinity's neighbour indices and ρ equal the JAX package's on data
free of near-ties. The loop starts from the JAX package's pre-loop state
and takes the draws the JAX package makes from each step's key: the
mid-near candidates (``randint(key, (n_mid_near, n, 6), 0, n - 1)``, drawn
only on the steps the JAX package's ``lax.cond`` runs) and the far pairs'
uniform draw (``uniform(fold_in(key, 1), (n, n_further))``). Tolerances:

- the affinity's ρ at 1e-5 relative (both from the same exact kNN
  distances); indices equal;
- one step in each of the three phases, with ``mn_resample_every`` 1 and
  3: the loss at 1e-5 relative, the gradient at 1e-5 absolute (float32 and
  float64 evaluations of the JAX package), the Adam step at 1e-5 absolute;
- a short run of the loop over all three phases: 1e-5 absolute on the
  embedding, from a spread start (3 · N(0, 1)) at Adam lr 0.01. From the
  PCA start (scale 1e-4) at the default lr 1, Adam's first step moves
  every coordinate by ±1, so rows pile onto four corners and the next
  steps amplify float32 rounding (measured: 6.9e-6 after one step, 0.012
  after two, 0.043 after 36); at lr 0.1 from the spread start the gap is
  3.0e-5, at lr 0.01 4.8e-6;
- a two-moons fit: silhouette above 0.15 and within 0.1 of the JAX fit's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.affinity.knn_normalized import PACMAPAffinity as JaxPACMAPAffinity
from torchdr_tpu.eval import silhouette_score
from torchdr_tpu.models.neighbor.pacmap import PACMAP as JaxPACMAP
from torchdr_tpu.utils.optim import make_optimizer as jax_make_optimizer
from torchdr_tpu_torch import PACMAP, KnnConfig, PACMAPAffinity
from torchdr_tpu_torch.utils.interop import load_reference_state
from torchdr_tpu_torch.utils.optim import make_optimizer


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


def test_pacmap_affinity_matches_jax():
    """Indices and ρ, then ``tests/test_affinity.py::test_pacmap_indices``'s
    checks on the port."""
    X = np.random.default_rng(0).normal(size=(300, 12)).astype(np.float32)
    ja = JaxPACMAPAffinity(n_neighbors=8)
    w_vals, w_idx = ja(X, return_indices=True)
    ta = PACMAPAffinity(n_neighbors=8, device="cpu")
    g_vals, g_idx = ta(X, return_indices=True)
    assert w_vals is None and g_vals is None
    assert g_idx.dtype == torch.int32 and g_idx.shape == (300, 8)
    np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
    np.testing.assert_allclose(ta.rho_.numpy(), np.asarray(ja.rho_), rtol=1e-5)
    assert not (g_idx.numpy() == np.arange(300)[:, None]).any()


def _pre_loop_state(kw, seed=4):
    X, _ = _blobs(seed=seed)
    Xj = jnp.asarray(X)
    jm = JaxPACMAP(**kw)
    jm.n_samples_in_, jm.n_features_in_ = X.shape
    jm._fit_mesh_ = None
    jm._compute_input_affinity(Xj)
    jm.on_affinity_computation_end()
    arrays = {
        "affinity_in": None,
        "NN_indices": np.asarray(jm.NN_indices_),
        "init_embedding": np.array(jm._init_embedding(Xj)),
        "neg_exclusion": np.asarray(jm.neg_exclusion_),
        "neg_valid_counts": np.asarray(jm.neg_valid_counts_),
    }
    tm = PACMAP(device="cpu", **kw)
    load_reference_state(tm, arrays)
    return jm, jm._build_consts(Xj), tm, tm._build_consts(torch.from_numpy(X)), arrays


def _jax_draws(jm, key, n, it):
    """The JAX step's draws from its key: the mid-near candidates where its
    ``lax.cond`` draws, and the far pairs' uniform draw."""
    _, w_MN, _ = jm._weights(it)
    draws = {"u": np.asarray(jax.random.uniform(jax.random.fold_in(key, 1),
                                                (n, jm.n_further)))}
    if float(w_MN) > 0 and it % jm.mn_resample_every == 0:
        draws["cand"] = np.asarray(jax.random.randint(key, (jm.n_mid_near, n, 6), 0, n - 1))
    return draws


def test_draw_mid_near_matches_jax():
    jm, jconsts, tm, tconsts, _ = _pre_loop_state(dict(n_neighbors=8, random_state=0))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jm._draw_mid_near(jconsts["X"], 300, key))
    cand = np.asarray(jax.random.randint(key, (jm.n_mid_near, 300, 6), 0, 299))
    got = tm._draw_mid_near(tconsts["X"], 300, cand=torch.from_numpy(cand))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("it, R", [(0, 1), (4, 1), (15, 1), (27, 1), (3, 3), (4, 3), (15, 3)])
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "in_float64"])
def test_one_step_matches_jax(it, R, x64):
    """Phases of 10 steps: steps 0 and 4 (phase 1, w_MN falling from 1000),
    15 (phase 2), 27 (phase 3, no mid-near term). With R = 3, step 3
    redraws the mid-near pairs and steps 4 and 15 reuse the carried ones."""
    kw = dict(n_neighbors=8, iter_per_phase=10, max_iter=30, random_state=0,
              mn_resample_every=R)
    jm, jconsts, tm, tconsts, arrays = _pre_loop_state(kw)
    n = 300
    Z = arrays["init_embedding"] if it == 0 else (
        np.random.default_rng(it).normal(size=(n, 2)).astype(np.float32))
    key = jax.random.PRNGKey(it)
    carry = {}
    if R > 1:
        carry_mn = np.random.default_rng(50 + it).integers(0, n, (n, jm.n_mid_near))
        carry = {"mid_near": carry_mn.astype(np.int32)}
    with jax.enable_x64(x64):
        draws = _jax_draws(jm, key, n, it)
        consts = _to_f64(jconsts) if x64 else jconsts
        jcarry = {k: jnp.asarray(v) for k, v in carry.items()}
        Zj = jnp.asarray(Z, jnp.float64 if x64 else jnp.float32)
        (w_loss, w_carry), w_grad = jax.value_and_grad(
            lambda v: jm._loss(v, consts, jcarry, it, key, 1.0), has_aux=True)(Zj)
        jopt = jax_make_optimizer("Adam")
        w_Z, _ = jopt.update(w_grad, jopt.init(Zj), Zj, 1.0, {})
        w_loss, w_grad, w_Z = float(w_loss), np.asarray(w_grad), np.asarray(w_Z)

    Zg = torch.from_numpy(Z).requires_grad_(True)
    tcarry = {k: torch.from_numpy(v) for k, v in carry.items()}
    cand = torch.from_numpy(draws["cand"]) if "cand" in draws else None
    attr, g_carry = tm._attractive_loss(Zg, tconsts, tcarry, it, cand=cand)
    rep, _ = tm._repulsive_loss(Zg, tconsts, g_carry, it, u=torch.from_numpy(draws["u"]))
    loss = attr + rep
    (g_grad,) = torch.autograd.grad(loss, Zg)
    opt = make_optimizer("Adam")
    g_Z, _ = opt.update(g_grad, opt.init(Zg.detach()), Zg.detach(), 1.0, {})

    np.testing.assert_allclose(float(loss), w_loss, rtol=1e-5)
    np.testing.assert_allclose(g_grad.numpy(), w_grad, atol=1e-5, rtol=0)
    np.testing.assert_allclose(g_Z.numpy(), w_Z, atol=1e-5, rtol=0)
    if R > 1:
        np.testing.assert_array_equal(g_carry["mid_near"].numpy(),
                                      np.asarray(w_carry["mid_near"]))


def _jax_step_keys(seed, steps):
    key, subs = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


@pytest.mark.parametrize("R", [1, 3])
def test_short_run_of_the_loop_matches_jax(R):
    """``_optimize`` of both packages over 36 steps, phases of 12 (the JAX
    package's phase-3 gating test's setting), each step on the JAX loop's
    draws (from a spread start at lr 0.01: see the module docstring): the
    Python ``if`` that gates the mid-near draw takes exactly the steps the
    JAX package's ``lax.cond`` takes (every draw handed out is used, and no
    other is asked for)."""
    kw = dict(n_neighbors=8, iter_per_phase=12, max_iter=36, random_state=0,
              mn_resample_every=R, lr=0.01)
    jm, jconsts, tm, tconsts, _ = _pre_loop_state(kw, seed=5)
    steps = [_jax_draws(jm, k, 300, it) for it, k in enumerate(_jax_step_keys(0, 36))]
    cands = [torch.from_numpy(d["cand"]) for d in steps if "cand" in d]
    us = [torch.from_numpy(d["u"]) for d in steps]
    draw, sample = tm._draw_mid_near, tm._sample_negatives
    tm._draw_mid_near = lambda X, n, cand=None: draw(X, n, cands.pop(0))
    tm._sample_negatives = lambda consts, u=None: sample(consts, u=us.pop(0))
    Z0 = (3.0 * np.random.default_rng(0).normal(size=(300, 2))).astype(np.float32)
    w_Z, w_it, _ = jm._optimize(jnp.asarray(Z0), jconsts, jm._init_carry(jconsts))
    g_Z, g_it, _ = tm._optimize(torch.from_numpy(Z0.copy()), tconsts, tm._init_carry(tconsts))
    assert int(w_it) == g_it == 36 and not cands and not us
    np.testing.assert_allclose(g_Z.numpy(), np.asarray(w_Z), atol=1e-5, rtol=0)


def test_weights_match_jax():
    jm, tm = JaxPACMAP(iter_per_phase=100), PACMAP(iter_per_phase=100, device="cpu")
    for it in (0, 1, 37, 99, 100, 199, 200, 449):
        assert tm._weights(it) == tuple(float(w) for w in jm._weights(it)), it


def test_moons_quality(toy_moons):
    """``tests/test_neighbor_embedding.py``'s PACMAP fit on two-moons, on the
    port: silhouette above 0.15 and within 0.1 of the JAX package's."""
    X, y = toy_moons
    kw = dict(n_neighbors=10, max_iter=450, random_state=0)
    Z = PACMAP(device="cpu", **kw).fit_transform(X)
    assert Z.shape == (100, 2) and np.isfinite(Z).all()
    s_port = float(silhouette_score(Z, y))
    assert s_port > 0.15
    assert abs(s_port - float(silhouette_score(np.asarray(JaxPACMAP(**kw).fit_transform(X)),
                                               y))) <= 0.1


def test_knn_mode_reaches_the_affinity():
    """``tests/test_neighbor_embedding.py::TestPACMAP::test_knn_mode_reaches_affinity``
    on the port."""
    rng = np.random.default_rng(0)
    c = rng.normal(scale=8.0, size=(8, 16)).astype(np.float32)
    X = (c[rng.integers(0, 8, 800)] + rng.normal(size=(800, 16))).astype(np.float32)
    m = PACMAP(n_neighbors=10, max_iter=40, random_state=0, device="cpu",
               knn_mode=KnnConfig(mode="ivf", nprobe=8, n_clusters=16))
    assert m.affinity_in.knn_mode == "ivf"
    Z = m.fit_transform(X)
    assert Z.shape == (800, 2) and np.isfinite(Z).all()


def test_mn_resample_every_below_one_raises():
    with pytest.raises(ValueError, match="mn_resample_every"):
        PACMAP(mn_resample_every=0, device="cpu")


def test_device_auto_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='auto' resolves to it")
    X, _ = _blobs(n=100, seed=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        PACMAP(n_neighbors=5, max_iter=5).fit_transform(X)


def test_params_follow_the_jax_defaults():
    jm, tm = JaxPACMAP(), PACMAP(device="cpu")
    for name in ("n_neighbors", "lr", "optimizer", "optimizer_kwargs", "scheduler", "max_iter",
                 "MN_ratio", "FP_ratio", "iter_per_phase", "n_mid_near", "n_further",
                 "n_negatives", "mn_resample_every", "min_grad_norm", "init", "init_scaling",
                 "check_interval", "metric", "knn_mode", "discard_NNs"):
        assert getattr(tm, name) == getattr(jm, name), name

"""The exact t-SNE/SNE slice of the PyTorch port against the JAX package.

The same numpy inputs, made from a seed, go through the JAX package and
the port (``device="cpu"``, where the row log-sum wrappers take their plain
versions and the JAX package takes its XLA tier).

Tolerances:

- indexed distances: rtol 1e-5, atol 1e-5 (the gram forms of both cancel
  near 0 for the dense modes; the per-key mode is a direct difference);
- the entropic calibration: rtol 1e-5 on eps and on log P (both bisect the
  same float32 function, whose values differ only in summation order);
- one optimizer step from the JAX package's pre-loop state: atol 1e-5 on
  the gradient and on the updated embedding (float32 sums of a few hundred
  terms in other orders, times a learning rate of at most 75 on gradients
  of ~1e-4);
- a short run of the loop, through the early-exaggeration switch: atol
  1e-5 on the embedding;
- a small full fit: silhouette within 0.1 of the JAX fit's (different
  summation orders make the trajectories drift apart over hundreds of
  steps, so only the quality is compared).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.affinity.entropic import EntropicAffinity as JaxEntropicAffinity
from torchdr_tpu.affinity.entropic import solve_entropic_affinity as jax_solve
from torchdr_tpu.eval import silhouette_score
from torchdr_tpu.models.neighbor.tsne import SNE as JaxSNE
from torchdr_tpu.models.neighbor.tsne import TSNE as JaxTSNE
from torchdr_tpu.ops.distance import knn_graph as jax_knn_graph
from torchdr_tpu.ops.distance import pairwise_distances_indexed as jax_indexed
from torchdr_tpu.utils.optim import make_optimizer as jax_make_optimizer
from torchdr_tpu_torch import SNE, TSNE, EntropicAffinity
from torchdr_tpu_torch.affinity.entropic import solve_entropic_affinity
from torchdr_tpu_torch.ops.distance import pairwise_distances_indexed
from torchdr_tpu_torch.utils.interop import load_reference_state
from torchdr_tpu_torch.utils.optim import make_optimizer


def _blobs(n=300, d=16, n_clusters=4, seed=0, scale=6.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(n_clusters, d))
    labels = rng.integers(0, n_clusters, n)
    return (centers[labels] + rng.normal(size=(n, d))).astype(np.float32), labels


@pytest.mark.parametrize("mode", ["keys_2d", "keys_1d", "all_keys", "queries_and_Y"])
def test_pairwise_distances_indexed_matches_jax(mode):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(120, 8)).astype(np.float32)
    Y = rng.normal(size=(90, 8)).astype(np.float32)
    kw_np = {}
    if mode == "keys_2d":
        keys = rng.integers(0, 120, (120, 7))
        keys[rng.random(keys.shape) < 0.1] = -1  # padding slots
        kw_np = {"key_indices": keys}
    elif mode == "keys_1d":
        kw_np = {"key_indices": rng.integers(0, 120, 33)}
    elif mode == "queries_and_Y":
        kw_np = {"query_indices": rng.integers(0, 120, 40), "key_indices": rng.integers(0, 90, 25)}
    use_Y = mode == "queries_and_Y"
    want = np.asarray(jax_indexed(
        jnp.asarray(X), Y=jnp.asarray(Y) if use_Y else None,
        **{k: jnp.asarray(v) for k, v in kw_np.items()},
    ))
    got = pairwise_distances_indexed(
        torch.from_numpy(X), Y=torch.from_numpy(Y) if use_Y else None,
        **{k: torch.from_numpy(v) for k, v in kw_np.items()},
    ).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "name", ["cross_entropy", "cross_entropy_log", "entropy", "entropy_log", "logsumexp",
             "sum", "masked_logsumexp"],
)
def test_reductions_match_jax(name):
    """rtol 1e-5: float32 sums of 150 x 6 entries in other orders."""
    from torchdr_tpu.ops import reductions as jr
    from torchdr_tpu_torch.ops import reductions as tr

    rng = np.random.default_rng(9)
    P = rng.random((150, 6)).astype(np.float32)
    logQ = np.log(rng.random((150, 6))).astype(np.float32)
    mask = rng.random((150, 6)) > 0.2
    calls = {
        "cross_entropy": lambda m, P, L, M, exp: m.cross_entropy_loss(P, exp(L)),
        "cross_entropy_log": lambda m, P, L, M, exp: m.cross_entropy_loss(P, L, log=True),
        "entropy": lambda m, P, L, M, exp: m.entropy(P, log=False),
        "entropy_log": lambda m, P, L, M, exp: m.entropy(L, log=True),
        "logsumexp": lambda m, P, L, M, exp: m.logsumexp_red(L, dim=1),
        "sum": lambda m, P, L, M, exp: m.sum_red(P, dim=0, keepdims=False),
        "masked_logsumexp": lambda m, P, L, M, exp: m.masked_logsumexp(L, M),
    }
    want = calls[name](jr, jnp.asarray(P), jnp.asarray(logQ), jnp.asarray(mask), jnp.exp)
    got = calls[name](tr, torch.from_numpy(P), torch.from_numpy(logQ), torch.from_numpy(mask),
                      torch.exp)
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_solve_entropic_affinity_matches_jax():
    X, _ = _blobs(seed=2)
    C, _ = jax_knn_graph(jnp.asarray(X - X.mean(0)), k=30)
    C = np.array(C)
    w_logP, w_eps = (np.asarray(a) for a in jax_solve(jnp.asarray(C), 10.0, max_iter=100))
    g_logP, g_eps = (a.numpy() for a in solve_entropic_affinity(torch.from_numpy(C), 10.0,
                                                                 max_iter=100))
    np.testing.assert_allclose(g_eps, w_eps, rtol=1e-5)
    np.testing.assert_allclose(g_logP, w_logP, rtol=1e-5)


def test_entropic_affinity_matches_jax():
    # unclustered data, checked free of near-ties at the 30th neighbour, so
    # that both kNN graphs hold the same edges
    X = np.random.default_rng(3).normal(size=(300, 12)).astype(np.float32)
    X64 = X.astype(np.float64)
    D = ((X64[:, None] - X64[None]) ** 2).sum(-1)
    np.fill_diagonal(D, np.inf)
    D.sort(1)
    assert ((D[:, 30] - D[:, 29]) / D[:, 29]).min() > 1e-5
    ja = JaxEntropicAffinity(perplexity=10, max_iter=100)
    wP, wNN = ja(jnp.asarray(X), return_indices=True)
    ta = EntropicAffinity(perplexity=10, max_iter=100, device="cpu")
    gP, gNN = ta(X, return_indices=True)
    wNN, gNN = np.asarray(wNN), gNN.numpy()
    for r in range(X.shape[0]):
        assert set(wNN[r]) == set(gNN[r])
    np.testing.assert_array_equal(gNN, wNN)  # both sorted by distance
    np.testing.assert_allclose(ta.eps_.numpy(), np.asarray(ja.eps_), rtol=1e-5)
    np.testing.assert_allclose(gP.numpy(), np.asarray(wP), rtol=1e-5, atol=1e-9)
    gL, _ = ta(X, return_indices=True, log=True)
    wL, _ = ja(jnp.asarray(X), return_indices=True, log=True)
    np.testing.assert_allclose(gL.numpy(), np.asarray(wL), rtol=1e-5)


def _pre_loop_state(jax_cls, port_cls, kw, seed=4):
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
    }
    tm = port_cls(device="cpu", **kw)
    load_reference_state(tm, arrays)
    return jm, jm._build_consts(Xj), tm, tm._build_consts(None), arrays


def _to_f64(tree):
    """A pytree with its floating arrays as float64 (inside
    ``jax.enable_x64``): the same values, float32-rounded where they were
    made in float32, in a float64 evaluation."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a,
        tree,
    )


def _jax_step(jm, jconsts, Z, buf, it, ee_iter, coeff, lr, momentum):
    """One step of the JAX loop body, built from its parts."""
    key = jax.random.PRNGKey(it)
    jopt = jax_make_optimizer("SGD")
    state = jopt.init(jnp.asarray(Z))
    if buf is not None:
        state = {**state, "buf": jnp.asarray(buf), "step": jnp.asarray(3)}
    if it == ee_iter + 1:
        state = jopt.reset(state)
    grad = jax.grad(lambda Zj: jm._loss(Zj, jconsts, {}, it, key, coeff)[0])(jnp.asarray(Z))
    Z_new, _ = jopt.update(grad, state, jnp.asarray(Z), lr, {"momentum": momentum})
    return np.asarray(grad), np.asarray(Z_new)


def _port_step(tm, tconsts, Z, buf, it, ee_iter):
    schedule = tm._make_schedule()
    coeff, lr_t, hyper = schedule(it)
    opt = make_optimizer("SGD")
    state = opt.init(torch.from_numpy(Z))
    if buf is not None:
        state = {"buf": torch.from_numpy(buf), "step": 3}
    if it == ee_iter + 1:
        state = opt.reset(state)
    grad, _ = tm._loss_gradients(torch.from_numpy(Z), tconsts, {}, it, coeff)
    Z_new, _ = opt.update(grad, state, torch.from_numpy(Z), lr_t, hyper)
    return grad.numpy(), Z_new.numpy(), (coeff, lr_t, hyper)


@pytest.mark.parametrize(
    "model, it",
    [("TSNE", 0), ("TSNE", 5), ("TSNE", 6), ("TSNE", 40), ("SNE", 0), ("SNE", 9)],
)
def test_one_step_matches_jax(model, it):
    """TSNE with early exaggeration over steps 0..5: step 5 is its last,
    step 6 the moment reset (it = ee_iter + 1); SNE has none."""
    _hold_one_step_to_jax(model, it, x64=False)


@pytest.mark.parametrize(
    "model, it",
    [("TSNE", 0), ("TSNE", 5), ("TSNE", 6), ("TSNE", 40), ("SNE", 0), ("SNE", 9)],
)
def test_one_step_matches_jax_in_float64(model, it):
    """The same steps with the JAX step evaluated in float64 on the same
    inputs, at the same 1e-5: a float32 evaluation of the JAX package has
    once come out 3.1e-4 off in a multi-worker run of the suite
    (``tests/_torch_threads.py``), and a float64 one does not depend on the
    summation order XLA picks."""
    _hold_one_step_to_jax(model, it, x64=True)


def _hold_one_step_to_jax(model, it, x64):
    ee_iter = 5 if model == "TSNE" else -1
    kw = dict(perplexity=10, max_iter=60, random_state=0)
    if model == "TSNE":
        kw["early_exaggeration_iter"] = ee_iter
        jm, jconsts, tm, tconsts, arrays = _pre_loop_state(JaxTSNE, TSNE, kw)
    else:
        jm, jconsts, tm, tconsts, arrays = _pre_loop_state(JaxSNE, SNE, kw)
    n = arrays["affinity_in"].shape[0]
    rng = np.random.default_rng(it)
    if it == 0:
        Z, buf = arrays["init_embedding"], None
    else:
        Z = (rng.normal(size=(n, 2))).astype(np.float32)
        buf = (1e-3 * rng.normal(size=(n, 2))).astype(np.float32)

    in_ee = it <= ee_iter
    coeff = 12.0 if in_ee else 1.0
    lr = max(n / 12.0 / 4.0, 50.0) if in_ee else max(n / 4.0, 50.0)
    momentum = 0.5 if in_ee else 0.8
    if x64:
        with jax.enable_x64(True):
            w_grad, w_Z = _jax_step(
                jm, _to_f64(jconsts), Z.astype(np.float64),
                None if buf is None else buf.astype(np.float64), it, ee_iter, coeff, lr, momentum,
            )
        assert w_grad.dtype == w_Z.dtype == np.float64
    else:
        w_grad, w_Z = _jax_step(jm, jconsts, Z, buf, it, ee_iter, coeff, lr, momentum)
    g_grad, g_Z, (t_coeff, t_lr, t_hyper) = _port_step(tm, tconsts, Z, buf, it, ee_iter)

    assert t_coeff == coeff and t_lr == pytest.approx(lr) and t_hyper == {"momentum": momentum}
    np.testing.assert_allclose(g_grad, w_grad, atol=1e-5, rtol=0)
    np.testing.assert_allclose(g_Z, w_Z, atol=1e-5, rtol=0)


@pytest.mark.parametrize("model", ["TSNE", "SNE"])
def test_short_run_of_the_loop_matches_jax(model):
    """The port's ``_optimize`` against the JAX package's over 10 steps from
    the same pre-loop state; TSNE's early exaggeration ends after step 3, so
    the run crosses the moment reset."""
    kw = dict(perplexity=10, max_iter=10, random_state=0)
    if model == "TSNE":
        kw["early_exaggeration_iter"] = 3
        jm, jconsts, tm, tconsts, arrays = _pre_loop_state(JaxTSNE, TSNE, kw, seed=5)
    else:
        jm, jconsts, tm, tconsts, arrays = _pre_loop_state(JaxSNE, SNE, kw, seed=5)
    Z0 = arrays["init_embedding"]
    w_Z, w_it, _ = jm._optimize(jnp.asarray(Z0), jconsts, {})
    g_Z, g_it, _ = tm._optimize(torch.from_numpy(Z0.copy()), tconsts, {})
    assert int(w_it) == g_it == 10
    np.testing.assert_allclose(g_Z.numpy(), np.asarray(w_Z), atol=1e-5, rtol=0)


@pytest.mark.parametrize("model", ["TSNE", "SNE"])
def test_short_run_of_the_loop_matches_jax_steps_in_float64(model):
    """The same 10 steps of the port's ``_optimize`` against the JAX
    package's step (``jax.grad`` of its loss, its optimizer and its moment
    reset) chained in float64 at the port's schedule, which
    ``test_one_step_matches_jax`` holds to the JAX package's: the JAX loop
    itself does not trace in float64 (its ``lax.cond`` branches return
    float32 constants). Same 1e-5."""
    ee_iter = 3 if model == "TSNE" else -1
    kw = dict(perplexity=10, max_iter=10, random_state=0)
    if model == "TSNE":
        kw["early_exaggeration_iter"] = ee_iter
        jm, jconsts, tm, tconsts, arrays = _pre_loop_state(JaxTSNE, TSNE, kw, seed=5)
    else:
        jm, jconsts, tm, tconsts, arrays = _pre_loop_state(JaxSNE, SNE, kw, seed=5)
    Z0 = arrays["init_embedding"]
    schedule = tm._make_schedule()
    with jax.enable_x64(True):
        jconsts64 = _to_f64(jconsts)
        jopt = jax_make_optimizer("SGD")
        Zj = jnp.asarray(Z0, jnp.float64)
        state = jopt.init(Zj)
        for it in range(10):
            coeff, lr_t, hyper = schedule(it)
            if it == ee_iter + 1:
                state = jopt.reset(state)
            key = jax.random.PRNGKey(it)
            grad = jax.grad(lambda Zv: jm._loss(Zv, jconsts64, {}, it, key, coeff)[0])(Zj)
            Zj, state = jopt.update(grad, state, Zj, lr_t, hyper)
        w_Z = np.asarray(Zj)
    assert w_Z.dtype == np.float64
    g_Z, g_it, _ = tm._optimize(torch.from_numpy(Z0.copy()), tconsts, {})
    assert g_it == 10
    np.testing.assert_allclose(g_Z.numpy(), w_Z, atol=1e-5, rtol=0)


def test_small_tsne_fit_silhouette_close_to_jax():
    X, y = _blobs(seed=6)
    kw = dict(perplexity=15, max_iter=300, random_state=0)
    Z_port = TSNE(device="cpu", **kw).fit_transform(X)
    Z_jax = np.asarray(JaxTSNE(**kw).fit_transform(X))
    assert Z_port.shape == (300, 2) and np.all(np.isfinite(Z_port))
    s_port = float(silhouette_score(Z_port, y))
    s_jax = float(silhouette_score(Z_jax, y))
    assert s_port >= 0.3
    assert abs(s_port - s_jax) <= 0.1


def test_sne_fit_counts_steps_and_times_phases():
    X, y = _blobs(n=150, seed=7)
    model = SNE(perplexity=10, max_iter=40, random_state=0, device="cpu")
    Z = model.fit_transform(X)
    assert model.n_iter_ == 40 and np.all(np.isfinite(Z))
    assert set(model.timings_) == {"knn", "affinity", "init", "optimize"} | {
        "fit", "api.check", "api.dedup", "api.h2d", "api.d2h",
        "optimize.consts", "optimize.loop", "optimize.wait"}


def test_tsne_device_auto_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='auto' resolves to it")
    X, _ = _blobs(n=100, seed=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSNE(perplexity=10, max_iter=5).fit_transform(X)


def test_tsne_params_follow_the_jax_defaults():
    port, ref = TSNE(device="cpu").get_params(), JaxTSNE().get_params()
    for name in ("perplexity", "lr", "optimizer", "optimizer_kwargs", "max_iter",
                 "early_exaggeration_coeff", "early_exaggeration_iter", "init",
                 "check_interval", "block_size", "min_grad_norm"):
        assert port[name] == ref[name], name

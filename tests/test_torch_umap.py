"""The UMAP slice of the PyTorch port against the JAX package.

The same numpy inputs, made from a seed, go through the JAX estimator and
the port (``device="cpu"``). On the CPU the JAX estimator takes its gram
repulsion, not the TPU kernel, so the one-step test builds the JAX step the
way ``_gradients`` combines it on the TPU: JAX ``_attractive_gradients``,
plus the TPU kernel in interpret mode on one draw of shared negatives, then
the SGD update. The port gets the same state (``load_reference_state``) and
the same negatives.

Tolerances: the one-step gradient and embedding agree to atol 1e-5 from the
state a fit starts in (the PCA init, where the float32 sums of both sides
are exact to ~1e-6). From a spread-out embedding the TPU kernel's
(Σ coef)·z_i − Σ coef·z_s form cancels in float32 (|coef| up to 2b/eps), so
there the port's step is held at 1e-5 to a JAX step whose repulsion is the
float64 direct-difference reference instead.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.affinity.knn_normalized import UMAPAffinity as JaxUMAPAffinity
from torchdr_tpu.eval import silhouette_score
from torchdr_tpu.models.neighbor.umap import UMAP as JaxUMAP
from torchdr_tpu.models.spectral.pca import PCA as JaxPCA
from torchdr_tpu.ops.pallas.umap_kernel import fused_shared_repulsion as jax_k1
from torchdr_tpu.ops.sparse import sparse_to_dense as jax_sparse_to_dense
from torchdr_tpu.utils.optim import make_optimizer as jax_make_optimizer
from torchdr_tpu_torch import UMAP, UMAPAffinity
from torchdr_tpu_torch.models.spectral.pca import PCA
from torchdr_tpu_torch.ops.sparse import sparse_to_dense
from torchdr_tpu_torch.utils.interop import load_reference_state
from torchdr_tpu_torch.utils.optim import make_optimizer


ROOT = pathlib.Path(__file__).resolve().parents[1]


def _blobs(n=600, d=16, n_clusters=4, seed=0, scale=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(n_clusters, d))
    labels = rng.integers(0, n_clusters, n)
    X = (centers[labels] + rng.normal(size=(n, d))).astype(np.float32)
    return X, labels


def test_umap_affinity_matches_jax():
    # Unclustered data: far-off clusters put |x|² well above the kNN
    # distances, and the gram form's float32 cancellation (last bits of
    # |x|², which the two packages sum in different orders) then moves P by
    # ΔC/σ. A near-tie at the k-th neighbour may resolve either way; this
    # seed's data has none (15th/16th gap > 1e-5 relative, in float64).
    X = np.random.default_rng(10).normal(size=(600, 16)).astype(np.float32)
    X64 = X.astype(np.float64)
    D = ((X64[:, None] - X64[None]) ** 2).sum(-1)
    np.fill_diagonal(D, np.inf)
    D.sort(1)
    assert ((D[:, 15] - D[:, 14]) / D[:, 14]).min() > 1e-5
    jP, jNN = JaxUMAPAffinity(n_neighbors=15)(jnp.asarray(X), return_indices=True)
    tP, tNN = UMAPAffinity(n_neighbors=15, device="cpu")(X, return_indices=True)
    want = np.asarray(jax_sparse_to_dense(jP, jNN, X.shape[0]))
    got = sparse_to_dense(tP, tNN, X.shape[0]).numpy()
    assert np.array_equal(got > 0, want > 0)  # the same edges
    # P <= 1; the calibrations agree to ~1e-5 relative (test_torch_ops)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("method", ["svd", "covariance"])
def test_pca_init_matches_jax(method):
    """The unit-variance PCA init (init_scaling=1), signs fixed by each
    method's convention."""
    X, _ = _blobs(n=1500, d=24, seed=2)
    want = np.asarray(JaxPCA(n_components=2, method=method)._fit_transform(jnp.asarray(X)))
    got = PCA(n_components=2, method=method, device="cpu")._fit_transform(torch.from_numpy(X))
    scale = want[:, 0].std()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-5, rtol=0)


@pytest.mark.parametrize("method", ["svd", "covariance"])
def test_pca_init_matches_jax_in_float64(method):
    """The same init with the JAX PCA evaluated in float64 on the same
    inputs, at the same 1e-5: a float64 evaluation does not depend on the
    summation order XLA picks (``tests/_torch_threads.py``)."""
    X, _ = _blobs(n=1500, d=24, seed=2)
    with jax.enable_x64(True):
        want = np.asarray(
            JaxPCA(n_components=2, method=method)._fit_transform(jnp.asarray(X, jnp.float64))
        )
    assert want.dtype == np.float64
    got = PCA(n_components=2, method=method, device="cpu")._fit_transform(torch.from_numpy(X))
    scale = want[:, 0].std()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-5, rtol=0)


def test_pca_auto_picks_covariance_for_tall_inputs():
    pca = PCA(device="cpu")
    assert pca._resolve_method(torch.zeros((60_000, 784))) == "covariance"
    assert pca._resolve_method(torch.zeros((600, 16))) == "svd"


def _to_f64(tree):
    """A pytree with its floating arrays as float64 (inside
    ``jax.enable_x64``)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a,
        tree,
    )


def _reference_f64_repulsion(Z, neg, w, a, b, eps):
    Z64 = np.asarray(Z, np.float64)
    Zn = Z64[neg]
    D = ((Z64[:, None, :] - Zn[None, :, :]) ** 2).sum(-1)
    coef = -2.0 * b / ((D + eps) * (1.0 + a * D**b))
    coef = np.where(neg[None, :] != np.arange(Z.shape[0])[:, None], coef, 0.0)
    coef = coef * np.asarray(w, np.float64)[:, None]
    return np.clip(coef.sum(1)[:, None] * Z64 - coef @ Zn, -4.0, 4.0)


@pytest.fixture(scope="module")
def step_states():
    """JAX pre-loop state (affinity, pruning, init, exclusion sets) for
    G=1 (exact) and G=4 (groups), as numpy arrays."""
    X, _ = _blobs(seed=3)
    Xj = jnp.asarray(X)
    states = {}
    for G, sched in ((1, "exact"), (4, "groups")):
        kw = dict(n_neighbors=15, max_iter=200, random_state=0, edge_groups=G, edge_schedule=sched)
        jm = JaxUMAP(**kw)
        jm.n_samples_in_, jm.n_features_in_ = X.shape
        jm._fit_mesh_ = None
        jm._compute_input_affinity(Xj)
        jm.on_affinity_computation_end()
        arrays = {
            "affinity_in": np.asarray(jm.affinity_in_),
            "NN_indices": np.asarray(jm.NN_indices_),
            "init_embedding": np.asarray(jm._init_embedding(Xj)),
            "neg_exclusion": np.asarray(jm.neg_exclusion_),
            "neg_valid_counts": np.asarray(jm.neg_valid_counts_),
            "a": jm._a,
            "b": jm._b,
        }
        states[sched] = (kw, jm, jm._build_consts(Xj), arrays)
    return states


@pytest.mark.parametrize("sched", ["exact", "groups"])
@pytest.mark.parametrize("start", ["init", "spread"])
def test_one_step_matches_jax(step_states, sched, start):
    _hold_one_step_to_jax(step_states, sched, start, x64=False)


@pytest.mark.parametrize("sched", ["exact", "groups"])
@pytest.mark.parametrize("start", ["init", "spread"])
def test_one_step_matches_jax_in_float64(step_states, sched, start):
    """The same steps against a float64 evaluation, at the same 1e-5: the
    JAX package's attraction and optimizer in float64 on the same inputs,
    the repulsion from the float64 reference on the negatives JAX draws
    (its TPU kernel has no float64 mode)."""
    _hold_one_step_to_jax(step_states, sched, start, x64=True)


def _hold_one_step_to_jax(step_states, sched, start, x64):
    kw, jm, jconsts, arrays = step_states[sched]
    n = arrays["affinity_in"].shape[0]
    tm = UMAP(device="cpu", **kw)
    load_reference_state(tm, arrays)
    tconsts = tm._build_consts(None)
    assert tconsts["edge_groups_G"] == jconsts["edge_groups_G"] == (4 if sched == "groups" else 1)
    S = jm._shared_negative_count(n)
    if start == "init":
        Z = arrays["init_embedding"]
        np.testing.assert_array_equal(tm.init_embedding_.numpy(), Z)
    else:
        Z = (3.0 * np.random.default_rng(4).normal(size=(n, 2))).astype(np.float32)

    schedule = tm._make_schedule()
    for it in (0, 1, 2, 3, 5, 37, 150, 199):
        key = jax.random.PRNGKey(it)
        neg = jax.random.randint(key, (S,), 0, n)
        lr_jax = 1.0 - it / kw["max_iter"]  # LinearLR 1 -> 0, lr=1
        jopt = jax_make_optimizer("SGD")
        if x64:
            with jax.enable_x64(True):
                jconsts64 = _to_f64(jconsts)
                Zj = jnp.asarray(Z, jnp.float64)
                g_attr, jcarry = jm._attractive_gradients(
                    Zj, jconsts64, jm._init_carry(jconsts64), it, key
                )
                counts = jnp.sum(jcarry["active_edges"], axis=1) * jm.negative_sample_rate
                w = np.asarray(counts, np.float32) / np.float32(S)  # the float32 w both take
                g_rep = _reference_f64_repulsion(Z, np.asarray(neg), w, jm._a, jm._b, jm._eps)
                g_jax = g_attr + jnp.asarray(g_rep)
                Z_jax, _ = jopt.update(g_jax, jopt.init(Zj), Zj, lr_jax, {"momentum": 0.0})
                g_jax, Z_jax = np.asarray(g_jax), np.asarray(Z_jax)
            assert g_jax.dtype == Z_jax.dtype == np.float64
        else:
            Zj = jnp.asarray(Z)
            g_attr, jcarry = jm._attractive_gradients(Zj, jconsts, jm._init_carry(jconsts), it, key)
            counts = jnp.sum(jcarry["active_edges"], axis=1) * jm.negative_sample_rate
            w = counts.astype(jnp.float32) / S
            if start == "init":
                g_rep = jax_k1(Zj, neg, w, jm._a, jm._b, jm._eps, interpret=True)
            else:
                g_rep = jnp.asarray(
                    _reference_f64_repulsion(Z, np.asarray(neg), np.asarray(w), jm._a, jm._b,
                                             jm._eps),
                    jnp.float32,
                )
            g_jax = g_attr + g_rep
            Z_jax, _ = jopt.update(g_jax, jopt.init(Zj), Zj, lr_jax, {"momentum": 0.0})

        Zt = torch.from_numpy(Z.copy())
        neg_t = torch.from_numpy(np.array(neg)).long()
        g_port, _ = tm._gradients(Zt, tconsts, tm._init_carry(tconsts), it, 1.0, neg_ids=neg_t)
        coeff, lr_t, hyper = schedule(it)
        assert coeff == 1.0 and lr_t == pytest.approx(lr_jax) and hyper == {"momentum": 0.0}
        opt = make_optimizer("SGD")
        Z_port, _ = opt.update(g_port, opt.init(Zt), Zt, lr_t, hyper)

        np.testing.assert_allclose(g_port.numpy(), np.asarray(g_jax), atol=1e-5, rtol=0)
        np.testing.assert_allclose(Z_port.numpy(), np.asarray(Z_jax), atol=1e-5, rtol=0)


def test_wide_embedding_gram_repulsion_matches_jax(step_states):
    """d > 8: the port keeps the reference's gram branch, which the JAX
    package takes on the CPU; both on the same shared negatives."""
    kw, jm, jconsts, arrays = step_states["exact"]
    n = arrays["affinity_in"].shape[0]
    tm = UMAP(device="cpu", **kw)
    load_reference_state(tm, arrays)
    tconsts = tm._build_consts(None)
    Z = np.random.default_rng(5).normal(size=(n, 9)).astype(np.float32)
    Zj, Zt = jnp.asarray(Z), torch.from_numpy(Z)
    it, key = 7, jax.random.PRNGKey(7)
    _, jcarry = jm._attractive_gradients(Zj, jconsts, jm._init_carry(jconsts), it, key)
    want, _ = jm._repulsive_gradients(Zj, jconsts, jcarry, it, key)
    neg = torch.from_numpy(np.array(jax.random.randint(key, (jm._shared_negative_count(n),), 0, n)))
    _, tcarry = tm._attractive_gradients(Zt, tconsts, tm._init_carry(tconsts), it)
    got, _ = tm._repulsive_gradients(Zt, tconsts, tcarry, it, neg_ids=neg.long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_wide_embedding_gram_repulsion_matches_f64_reference(step_states):
    """The same gram branch (d > 8) held to the float64 reference by direct
    differences, at the same 1e-5: the JAX branch draws its negatives
    inside, and another draw in float64 mode, so it cannot be evaluated in
    float64 on the same negatives."""
    kw, jm, jconsts, arrays = step_states["exact"]
    n = arrays["affinity_in"].shape[0]
    tm = UMAP(device="cpu", **kw)
    load_reference_state(tm, arrays)
    tconsts = tm._build_consts(None)
    Z = np.random.default_rng(5).normal(size=(n, 9)).astype(np.float32)
    Zt = torch.from_numpy(Z)
    it = 7
    S = jm._shared_negative_count(n)
    neg = np.array(jax.random.randint(jax.random.PRNGKey(it), (S,), 0, n))
    _, tcarry = tm._attractive_gradients(Zt, tconsts, tm._init_carry(tconsts), it)
    got, _ = tm._repulsive_gradients(Zt, tconsts, tcarry, it, neg_ids=torch.from_numpy(neg).long())
    w = (tcarry["active_edges"].sum(1) * tm.negative_sample_rate).float().numpy() / np.float32(S)
    want = _reference_f64_repulsion(Z, neg, w, tm._a, tm._b, tm._eps)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _per_point_state():
    """JAX and port models with shared_negatives=False and discard_NNs, the
    port loaded with the JAX pre-loop state."""
    X, _ = _blobs(n=300, seed=9)
    Xj = jnp.asarray(X)
    kw = dict(n_neighbors=10, max_iter=100, random_state=0, discard_NNs=True,
              shared_negatives=False)
    jm = JaxUMAP(**kw)
    jm.n_samples_in_, jm.n_features_in_ = X.shape
    jm._fit_mesh_ = None
    jm._compute_input_affinity(Xj)
    jm.on_affinity_computation_end()
    jconsts = jm._build_consts(Xj)
    arrays = {
        "affinity_in": np.asarray(jm.affinity_in_),
        "NN_indices": np.asarray(jm.NN_indices_),
        "init_embedding": np.asarray(jm._init_embedding(Xj)),
        "neg_exclusion": np.asarray(jm.neg_exclusion_),
        "neg_valid_counts": np.asarray(jm.neg_valid_counts_),
        "a": jm._a,
        "b": jm._b,
    }
    tm = UMAP(device="cpu", **kw)
    load_reference_state(tm, arrays)
    return jm, jconsts, tm, tm._build_consts(None)


def test_per_point_negatives_match_jax():
    """shared_negatives=False with discard_NNs: the sorted-exclusion draw and
    the per-point repulsion, on the uniform draw JAX makes from its key."""
    jm, jconsts, tm, tconsts = _per_point_state()
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, (300, jm.n_negatives)))
    want_ids = np.asarray(jm._sample_negatives(key, jconsts))
    got_ids = tm._sample_negatives(tconsts, u=torch.from_numpy(u)).numpy()
    # equal ids, quirk included: the one-pass shift past the sorted
    # exclusions can land on an excluded id (self among them) when excluded
    # ids are consecutive; the port copies the reference here
    np.testing.assert_array_equal(got_ids, want_ids)

    draw = tm._sample_negatives
    tm._sample_negatives = lambda consts, u=None: draw(consts, u=torch.from_numpy(u_in))
    Z = (3.0 * np.random.default_rng(6).normal(size=(300, 2))).astype(np.float32)
    Zj, Zt = jnp.asarray(Z), torch.from_numpy(Z)
    for it in (0, 4):
        key = jax.random.PRNGKey(it)
        u_in = np.array(jax.random.uniform(key, (300, jm.n_negatives)))
        _, jcarry = jm._attractive_gradients(Zj, jconsts, jm._init_carry(jconsts), it, key)
        want, _ = jm._repulsive_gradients(Zj, jconsts, jcarry, it, key)
        _, tcarry = tm._attractive_gradients(Zt, tconsts, tm._init_carry(tconsts), it)
        got, _ = tm._repulsive_gradients(Zt, tconsts, tcarry, it)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_per_point_repulsion_matches_f64_reference():
    """The per-point repulsion (shared_negatives=False) held to a float64
    numpy reference on the ids the port draws from a given uniform draw
    (``test_per_point_negatives_match_jax`` holds those ids to JAX's), at
    the same 1e-5 as the float32 JAX comparison there."""
    _, _, tm, tconsts = _per_point_state()
    rng = np.random.default_rng(8)
    Z = (3.0 * rng.normal(size=(300, 2))).astype(np.float32)
    Zt = torch.from_numpy(Z)
    draw = tm._sample_negatives
    for it in (0, 4):
        u = rng.random((300, tm.n_negatives)).astype(np.float32)
        tm._sample_negatives = lambda consts, u_in=u: draw(consts, u=torch.from_numpy(u_in))
        ids = tm._sample_negatives(tconsts).numpy()
        _, tcarry = tm._attractive_gradients(Zt, tconsts, tm._init_carry(tconsts), it)
        got, _ = tm._repulsive_gradients(Zt, tconsts, tcarry, it)
        counts = (tcarry["active_edges"].sum(1) * tm.negative_sample_rate).numpy()
        Z64 = Z.astype(np.float64)
        diff = Z64[:, None, :] - Z64[ids]
        D = (diff**2).sum(-1)
        coef = -2.0 * tm._b / ((D + tm._eps) * (1.0 + tm._a * D**tm._b))
        coef = np.where(np.arange(tm.n_negatives)[None, :] >= counts[:, None], 0.0, coef)
        want = np.clip((diff * coef[:, :, None]).sum(1), -4.0, 4.0)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "name, hyper",
    [("SGD", {"momentum": 0.5}), ("Adam", {"beta1": 0.8, "weight_decay": 0.01})],
)
def test_optimizer_matches_jax_across_reset(name, hyper):
    rng = np.random.default_rng(10)
    Z = rng.normal(size=(50, 2)).astype(np.float32)
    grads = rng.normal(size=(5, 50, 2)).astype(np.float32)
    jopt, topt = jax_make_optimizer(name), make_optimizer(name)
    Zj, jstate = jnp.asarray(Z), jopt.init(jnp.asarray(Z))
    Zt, tstate = torch.from_numpy(Z.copy()), topt.init(torch.from_numpy(Z.copy()))
    for step, g in enumerate(grads):
        if step == 3:  # the moment reset after early exaggeration
            jstate, tstate = jopt.reset(jstate), topt.reset(tstate)
        Zj, jstate = jopt.update(jnp.asarray(g), jstate, Zj, 0.1, hyper)
        Zt, tstate = topt.update(torch.from_numpy(g), tstate, Zt, 0.1, hyper)
        # atol 1e-5: JAX forms Adam's bias correction 1 - b2**t in float32
        # (relative error ~6e-5 at t = 1), the port in float64
        np.testing.assert_allclose(Zt.numpy(), np.asarray(Zj), atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "name, kwargs",
    [
        (None, None),
        ("LinearLR", {"start_factor": 1.0, "end_factor": 0.0}),
        ("ExponentialLR", {"gamma": 0.9}),
        ("CosineAnnealingLR", {"eta_min_ratio": 0.1}),
        ("ConstantLR", {"factor": 0.5, "total_iters": 4}),
    ],
)
def test_scheduler_matches_jax(name, kwargs):
    from torchdr_tpu.utils.schedulers import make_scheduler as jax_make_scheduler
    from torchdr_tpu_torch.utils.schedulers import make_scheduler

    jf, tf = jax_make_scheduler(name, kwargs), make_scheduler(name, kwargs)
    for t in (0.0, 1.0, 3.0, 4.0, 9.0, 10.0):
        assert tf(t, 10.0) == pytest.approx(float(jf(t, 10.0)), rel=1e-6, abs=1e-7)


def test_small_fit_silhouette_close_to_jax():
    X, y = _blobs(seed=5)
    Z_port = UMAP(n_neighbors=15, max_iter=200, random_state=0, device="cpu").fit_transform(X)
    Z_jax = np.asarray(JaxUMAP(n_neighbors=15, max_iter=200, random_state=0).fit_transform(X))
    assert Z_port.shape == (600, 2) and np.all(np.isfinite(Z_port))
    s_port = float(silhouette_score(Z_port, y))
    s_jax = float(silhouette_score(Z_jax, y))
    assert s_port >= 0.15
    assert abs(s_port - s_jax) <= 0.1


def test_umap_affinity_ivf_matches_jax():
    """``knn_mode=KnnConfig(mode="ivf")`` in both packages, at 16 cells with
    nprobe 16: every cell is probed, so both IVF graphs are the exact graph
    and the affinities agree as the exact tier's do (data and tolerance of
    ``test_umap_affinity_matches_jax``, 2e-5); so does the port's IVF
    affinity with its exact one (3.9e-6 apart when this test held them at
    1e-6: the IVF distances are the scan scores |x|² − 2q·x + |q|², the
    exact ones a gram of centred rows)."""
    from torchdr_tpu.ops.knn_config import KnnConfig as JaxKnnConfig
    from torchdr_tpu_torch import KnnConfig

    X = np.random.default_rng(10).normal(size=(600, 16)).astype(np.float32)
    kw = dict(mode="ivf", n_clusters=16, nprobe=16)
    jP, jNN = JaxUMAPAffinity(n_neighbors=15, knn_mode=JaxKnnConfig(**kw))(
        jnp.asarray(X), return_indices=True)
    aff = UMAPAffinity(n_neighbors=15, knn_mode=KnnConfig(**kw), device="cpu")
    tP, tNN = aff(X, return_indices=True)
    assert "knn" in aff.timings_
    want = np.asarray(jax_sparse_to_dense(jP, jNN, X.shape[0]))
    got = sparse_to_dense(tP, tNN, X.shape[0]).numpy()
    assert np.array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    eP, eNN = UMAPAffinity(n_neighbors=15, device="cpu")(X, return_indices=True)
    exact = sparse_to_dense(eP, eNN, X.shape[0]).numpy()
    assert np.array_equal(got > 0, exact > 0)
    np.testing.assert_allclose(got, exact, atol=2e-5, rtol=0)


def test_small_fit_on_the_ivf_graph():
    """UMAP with the IVF preset on the CPU: 10-NN label accuracy >= 0.9."""
    from torchdr_tpu.eval import knn_label_accuracy
    from torchdr_tpu_torch import IVF

    X, y = _blobs(n=1000, seed=7)
    model = UMAP(n_neighbors=15, max_iter=200, random_state=0, knn_mode=IVF, device="cpu")
    Z = model.fit_transform(X)
    assert Z.shape == (1000, 2) and np.all(np.isfinite(Z))
    assert model.timings_["knn"] > 0
    assert float(knn_label_accuracy(Z, y, k=10)) >= 0.9


def test_the_fits_here_run_on_a_single_torch_thread():
    """The module's CPU fits run on the one torch thread that the fixture of
    ``tests/_torch_threads.py`` sets for every port test module."""
    assert torch.get_num_threads() == 1


def test_fit_counts_steps_and_times_phases():
    X, _ = _blobs(n=200, seed=6)
    model = UMAP(n_neighbors=10, max_iter=30, random_state=0, device="cpu")
    model.fit_transform(X)
    assert model.n_iter_ == 30
    assert set(model.timings_) == {"knn", "affinity", "init", "optimize"} | {
        "fit", "api.check", "api.dedup", "api.h2d", "api.d2h",
        "optimize.consts", "optimize.loop", "optimize.wait"}


def test_device_auto_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='auto' resolves to it")
    X, _ = _blobs(n=100, seed=7)
    with pytest.raises(RuntimeError, match="CUDA"):
        UMAP(n_neighbors=10, max_iter=5).fit_transform(X)


def test_bands_schedule_is_not_ported_yet():
    """The bands schedule, refused before its port, fits (its parity with the
    JAX package is in tests/test_torch_bands.py)."""
    X, _ = _blobs(n=100, seed=8)
    model = UMAP(n_neighbors=10, max_iter=5, device="cpu", edge_schedule="bands")
    Z = model.fit_transform(X)
    assert Z.shape == (100, 2) and np.isfinite(Z).all() and model.n_iter_ == 5
    assert len(model.band_widths_) == 7


@pytest.mark.parametrize("sched, groups", [
    ("exact", 4), ("exact", 1), ("groups", 4), ("exact", "auto"), ("auto", 3),
])
def test_edge_groups_warning_matches_jax(sched, groups):
    """``edge_groups`` set with a schedule other than ``groups`` warns, as
    the JAX package warns, with its text; otherwise nothing is said."""
    import warnings

    n = 1000
    with warnings.catch_warnings(record=True) as want:
        warnings.simplefilter("always")
        want_sched = JaxUMAP(edge_groups=groups, edge_schedule=sched)._edge_schedule_for(n)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        model = UMAP(edge_groups=groups, edge_schedule=sched, device="cpu")
        got_sched = model._edge_schedule_for(n)
    assert got_sched == want_sched
    want = [(w.category, str(w.message)) for w in want if "edge_groups" in str(w.message)]
    got = [(w.category, str(w.message).replace("TorchDR-Torch", "TorchDR-TPU")) for w in got]
    assert got == want
    assert bool(got) == (sched == "exact" and groups != "auto")


def test_edge_groups_warning_with_the_exact_schedule():
    with pytest.warns(UserWarning, match=r"\[TorchDR-Torch\] edge_groups=4 is ignored"):
        model = UMAP(edge_groups=4, edge_schedule="exact", device="cpu")
        assert model._edge_schedule_for(10) == "exact"


def test_edge_groups_warning_comes_before_bands_is_refused():
    """edge_groups with the bands schedule warns, and bands is taken."""
    with pytest.warns(UserWarning, match="ignored with edge_schedule='bands'"):
        assert UMAP(edge_groups=2, edge_schedule="bands",
                    device="cpu")._edge_schedule_for(10) == "bands"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "torchdr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    assert ROOT / "torchdr_tpu_torch" / "benchmarks" / "gather_microbench.py" in files
    for new in ("ops/ivf.py", "ops/kmeans.py", "benchmarks/ivf_recall.py", "affinity/quadratic.py",
                "models/neighbor/largevis.py", "models/neighbor/pacmap.py",
                "models/neighbor/tsnekhorn.py", "utils/lobpcg.py",
                "models/spectral/kernel_pca.py", "models/spectral/incremental_pca.py",
                "models/spectral/phate.py", "eval/__init__.py", "eval/knn_metrics.py",
                "eval/silhouette.py", "eval/kmeans_ari.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/knn.py", "parallel/sparse.py", "parallel/ivf.py",
                "utils/manifold.py", "utils/encoders.py", "models/neighbor/cosne.py",
                "ops/pq.py", "ops/loader.py", "ops/streaming.py", "utils/native_loader.py",
                "cli.py", "utils/checkpoint.py", "utils/profiling.py", "utils/visu.py",
                "utils/__init__.py"):
        assert ROOT / "torchdr_tpu_torch" / new in files
    banned = ("jax", "jaxlib", "flax", "torchdr_tpu")
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in banned, f"{path.relative_to(ROOT)} imports {mod}"


# Names of the JAX package that the port replaces on purpose, each with its
# counterparts (``module:attribute``) and the reason. No name waits for a
# ROADMAP item any more.
_BUILD = "torchdr_tpu_torch.ops.cuda.build"
_REPLACED = {
    ".utils": {
        "to_jax": (("torchdr_tpu_torch.utils:to_torch",),
                   "the port's arrays are torch tensors"),
        "compile_cache_dir": ((f"{_BUILD}:build_dir",),
                              "XLA's persistent cache has no use: nvcc is the only compiler, "
                              "and its libraries are kept by a hash of their source and flags "
                              "under the package's _build/ where it is writable, else under "
                              "~/.cache/torchdr_tpu_torch/build"),
        "enable_compile_cache": ((f"{_BUILD}:build_libraries",), "the same"),
    },
    ".parallel": {
        "row_sharding": (("torchdr_tpu_torch.parallel:ShardedRows",
                          "torchdr_tpu_torch.parallel:shard_rows"),
                         "a NamedSharding has no torch meaning; rows are placed as pieces"),
        "replicated": (("torchdr_tpu_torch.parallel:ShardedRows",
                        "torchdr_tpu_torch.parallel:shard_rows",
                        "torchdr_tpu_torch.parallel:replicate"),
                       "the same; a replicated tensor is one copy per device"),
    },
}


def _public_names(mod):
    """``__all__``, or where a module has none, its public attributes that
    are not modules."""
    import types

    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("module", ["", ".ops", ".utils", ".parallel", ".eval", ".affinity",
                                    ".models", ".models.neighbor", ".models.spectral"])
def test_exports_match_the_jax_package(module):
    """Every public name of each JAX subpackage is exported by the port's,
    but those the port replaces on purpose (``_REPLACED``), whose
    counterparts are there instead; each name resolves."""
    import importlib

    jax_mod = importlib.import_module("torchdr_tpu" + module)
    port = importlib.import_module("torchdr_tpu_torch" + module)
    replaced = _REPLACED.get(module, {})
    missing = sorted(_public_names(jax_mod) - _public_names(port))
    assert missing == sorted(replaced), missing
    assert not [n for n in _public_names(jax_mod) if n not in replaced and not hasattr(port, n)]
    assert not [n for n in _public_names(port) if not hasattr(port, n)]
    assert not [n for n in replaced if hasattr(port, n)]
    for counterparts, reason in replaced.values():
        assert reason
        for target in counterparts:
            mod_name, attr = target.split(":")
            assert hasattr(importlib.import_module(mod_name), attr), target


def test_neighbor_embedding_bases_resolve_from_the_models_packages():
    from torchdr_tpu_torch.models import NegativeSamplingNeighborEmbedding, NeighborEmbedding
    from torchdr_tpu_torch.models import neighbor
    from torchdr_tpu_torch.models.neighbor.base import (
        NegativeSamplingNeighborEmbedding as NSNE,
        NeighborEmbedding as NE,
    )

    assert NeighborEmbedding is NE is neighbor.NeighborEmbedding
    assert NegativeSamplingNeighborEmbedding is NSNE is neighbor.NegativeSamplingNeighborEmbedding

"""The parametric path of the port (``encoder=``) against the JAX package's.

The flax MLP's weights are carried into the port's ``MLP`` by
``utils/interop.load_encoder_variables``; both packages then start from
the JAX package's pre-loop state and the same weights, and the steps that
draw negatives take the JAX package's draw (``randint(key, (S,), 0, n)``,
handed to the port through its ``_draw_shared_negatives``). Tolerances:

- the MLP's output on the flax weights: 1e-6 of its largest entry (the
  two matrix products sum in other orders);
- three steps of t-SNE (K2 and K3 by their plain versions), UMAP (K1's
  plain version, its dZ chained through the encoder) and LargeVis, each
  from the JAX package's weights of the step before: the gradient with
  respect to the weights, and the weights after an SGD step (lr 1e-2, the
  estimators' momentum), each within 1e-5 of its largest entry (measured
  2e-6 on weights of ~0.9). UMAP's dZ is held at 1e-5 (as in
  ``tests/test_torch_umap.py``) to the JAX package's attraction plus the
  repulsion evaluated in float64 on the same negatives, at the Z the port
  computed, and its chain into the weights to the JAX package's vjp of
  that dZ (a dZ term near a collision moves by ~1e-5 when Z moves by its
  rounding): the port's K1 sums
  direct differences, and the JAX package's CPU gram form loses digits at
  near-collisions. SGD, because Adam's first steps divide each weight's
  gradient by its own magnitude: the output bias's gradient is a sum of dZ
  over the rows, ~0 for a translation-invariant loss, so its rounding
  noise would decide the sign of a whole step;
- ten steps of the parametric t-SNE loop against the JAX package's loop:
  the embedding at 1e-5, and ``transform`` of rows the fit did not see at
  1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.models.neighbor.largevis import LargeVis as JaxLargeVis
from torchdr_tpu.models.neighbor.tsne import TSNE as JaxTSNE
from torchdr_tpu.models.neighbor.umap import UMAP as JaxUMAP
from torchdr_tpu.utils.encoders import make_mlp_encoder as jax_make_mlp_encoder
from torchdr_tpu.utils.optim import make_optimizer as jax_make_optimizer
from torchdr_tpu_torch import TSNE, UMAP, LargeVis
from torchdr_tpu_torch.eval import silhouette_score
from torchdr_tpu_torch.utils.encoders import MLP, make_mlp_encoder
from torchdr_tpu_torch.utils.interop import load_encoder_variables, load_reference_state
from torchdr_tpu_torch.utils.optim import make_optimizer

MODELS = {
    "TSNE": (JaxTSNE, TSNE, dict(perplexity=10)),
    "UMAP": (JaxUMAP, UMAP, dict(n_neighbors=10)),
    "LargeVis": (JaxLargeVis, LargeVis, dict(perplexity=10)),
}


def _blobs(n=120, d=8, seed=3):
    """Three blobs, standardized: the encoder's output at its initial
    weights is then O(1), where a float32 gram of squared distances keeps
    its digits."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=8.0, size=(3, d))
    labels = np.repeat(np.arange(3), n // 3)
    X = centers[labels] + rng.normal(size=(n, d))
    return ((X - X.mean(0)) / X.std(0)).astype(np.float32), labels


def _reference_f64_repulsion(Z, neg, w, a, b, eps):
    """UMAP's shared-negative repulsion in float64 (test_torch_umap.py's)."""
    Z64 = np.asarray(Z, np.float64)
    Zn = Z64[neg]
    D = ((Z64[:, None, :] - Zn[None, :, :]) ** 2).sum(-1)
    coef = -2.0 * b / ((D + eps) * (1.0 + a * D**b))
    coef = np.where(neg[None, :] != np.arange(Z.shape[0])[:, None], coef, 0.0)
    coef = coef * np.asarray(w, np.float64)[:, None]
    return np.clip(coef.sum(1)[:, None] * Z64 - coef @ Zn, -4.0, 4.0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_loaded_mlp_gives_the_flax_output():
    X, _ = _blobs()
    enc = jax_make_mlp_encoder(2, (32, 16))
    variables = enc.init(jax.random.PRNGKey(0), jnp.asarray(X[:1]))
    want = np.asarray(enc.apply(variables, jnp.asarray(X)))
    mlp = make_mlp_encoder(2, (32, 16))
    loaded = load_encoder_variables(mlp, _np_tree(variables))
    assert [tuple(v.shape) for v in loaded.values()] == [(32, 8), (32,), (16, 32), (16,), (2, 16),
                                                         (2,)]
    with torch.no_grad():
        got = mlp(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)
    with pytest.raises(ValueError, match="widths"):
        load_encoder_variables(make_mlp_encoder(3, (32, 16)), _np_tree(variables))


def test_mlp_draw_follows_flax_lecun_normal():
    """Weights of a truncated normal (|w| ≤ 2·scale) with flax's scale,
    sqrt(1/fan_in)/0.8796, so their standard deviation is sqrt(1/fan_in);
    biases zero; the same generator seed gives the same draw."""
    mlp = make_mlp_encoder(2, (512,))
    X = torch.zeros((1, 400))
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        draws.append(mlp.init_variables(X, gen))
    w = draws[0]["layers.0.weight"]
    scale = (1 / 400) ** 0.5 / 0.87962566103423978
    assert w.shape == (512, 400) and float(w.abs().max()) <= 2 * scale + 1e-7
    assert float(w.std()) == pytest.approx((1 / 400) ** 0.5, rel=0.02)
    assert not torch.any(draws[0]["layers.0.bias"])
    assert all(torch.equal(draws[0][k], draws[1][k]) for k in draws[0])


def _pre_loop_state(model, max_iter=10):
    jax_cls, port_cls, kw = MODELS[model]
    kw = dict(kw, max_iter=max_iter, optimizer="SGD", lr=1e-2, random_state=0)
    X, _ = _blobs()
    Xj, Xt = jnp.asarray(X), torch.from_numpy(X)
    jm = jax_cls(encoder=jax_make_mlp_encoder(2, (16,)), **kw)
    jm.n_samples_in_, jm.n_features_in_ = X.shape
    jm._fit_mesh_ = None
    jm._compute_input_affinity(Xj)
    jm.on_affinity_computation_end()
    Z0 = np.array(jm._init_embedding(Xj))  # the flax weights, from the root key
    arrays = {"affinity_in": np.asarray(jm.affinity_in_), "NN_indices": np.asarray(jm.NN_indices_),
              "init_embedding": Z0}
    if model != "TSNE":
        arrays.update(neg_exclusion=np.asarray(jm.neg_exclusion_),
                      neg_valid_counts=np.asarray(jm.neg_valid_counts_))
    if model == "UMAP":
        arrays.update(a=jm._a, b=jm._b)
    tm = port_cls(encoder=make_mlp_encoder(2, (16,)), device="cpu", **kw)
    load_reference_state(tm, arrays)
    variables = load_encoder_variables(tm.encoder, _np_tree(jm._encoder_variables0_))
    np.testing.assert_allclose(tm._init_embedding(Xt, draw=variables).numpy(), Z0,
                               atol=1e-6 * np.abs(Z0).max(), rtol=0)
    return jm, jm._build_consts(Xj), tm, tm._build_consts(Xt), X


def _port_names(tree):
    """The flax weights as the port's MLP names them (kernels transposed)."""
    out = {}
    for i in range(len(tree["params"])):
        layer = tree["params"][f"Dense_{i}"]
        out[f"layers.{i}.weight"] = np.asarray(layer["kernel"]).T
        out[f"layers.{i}.bias"] = np.asarray(layer["bias"])
    return out


def _flat(tree):
    """Flax weights as the port's flat vector."""
    return torch.cat([torch.from_numpy(np.ascontiguousarray(v).reshape(-1))
                      for v in _port_names(tree).values()])


@pytest.mark.parametrize("model", ["TSNE", "UMAP", "LargeVis"])
def test_first_steps_match_jax(model):
    jm, jconsts, tm, tconsts, X = _pre_loop_state(model)
    n = X.shape[0]
    Xj = jnp.asarray(X)
    enc = jm.encoder

    def to_Z(theta):
        return enc.apply(theta, Xj)

    def jax_grad(theta, it, key, coeff, neg):
        if model != "UMAP":
            return jax.grad(lambda th: jm._loss(to_Z(th), jconsts, {}, it, key, coeff)[0])(theta)
        # UMAP: the JAX loop's vjp of the dZ the port's step computed, at
        # the Z it computed it on; that dZ is held to the JAX attraction
        # plus the repulsion in float64 on the same negatives (the JAX
        # package's CPU gram form loses digits at near-collisions)
        Z, dZ = (seen[k].numpy() for k in ("Z", "dZ"))
        g_attr, carry = jm._attractive_gradients(jnp.asarray(Z), jconsts,
                                                 jm._init_carry(jconsts), it, key)
        w = np.asarray(jnp.sum(carry["active_edges"], axis=1) * jm.negative_sample_rate,
                       np.float32) / np.float32(len(neg))
        want_dZ = np.asarray(g_attr) + _reference_f64_repulsion(Z, neg, w, jm._a, jm._b, jm._eps)
        np.testing.assert_allclose(dZ, want_dZ, atol=1e-5, rtol=0)
        return jax.vjp(to_Z, theta)[1](jnp.asarray(dZ))[0]

    seen = {}
    port_gradients = tm._gradients

    def spy(Z, *args, **kwargs):  # the dZ that the port chains into the weights
        seen["Z"] = Z
        seen["dZ"], carry = port_gradients(Z, *args, **kwargs)
        return seen["dZ"], carry

    tm._gradients = spy
    theta0, to_Z_port = tm._encoder_map(torch.from_numpy(X))
    jopt, topt = jax_make_optimizer("SGD"), make_optimizer("SGD")
    jtheta, jstate = jm._encoder_variables0_, jopt.init(jm._encoder_variables0_)
    ttheta, tstate = theta0, topt.init(theta0)
    schedule = tm._make_schedule()
    for it in range(3):
        key = jax.random.PRNGKey(it)
        neg = None
        if model != "TSNE":
            neg = np.asarray(jax.random.randint(key, (jm._shared_negative_count(n),), 0, n))
            tm._draw_shared_negatives = lambda n_, S, dev, neg=neg: torch.from_numpy(neg).long()
        coeff, lr_t, hyper = schedule(it)
        tg, _ = tm._encoder_gradients(to_Z_port, ttheta, tconsts, tm._init_carry(tconsts), it,
                                      coeff)
        jg = jax_grad(jtheta, it, key, coeff, neg)
        want_g, got_g = _port_names(jg), tm._encoder_flat_.unflatten(tg)
        scale = max(np.abs(w).max() for w in want_g.values())
        for name, w in want_g.items():
            np.testing.assert_allclose(got_g[name].numpy(), w, atol=1e-5 * scale, rtol=0,
                                       err_msg=f"step {it} {name}")
        jtheta, jstate = jopt.update(jg, jstate, jtheta, lr_t, hyper)
        ttheta, tstate = topt.update(tg, tstate, ttheta, lr_t, hyper)
        got_w, want_w = tm._encoder_flat_.unflatten(ttheta), _port_names(jtheta)
        w_scale = max(np.abs(w).max() for w in want_w.values())
        for name, w in want_w.items():
            np.testing.assert_allclose(got_w[name].numpy(), w, atol=1e-5 * w_scale, rtol=0)
        # the next step starts from the JAX package's weights and momentum
        ttheta = _flat(jtheta)
        tstate = {"buf": _flat(jstate["buf"]), "step": int(jstate["step"])}


def test_tsne_loop_and_transform_of_new_rows_match_jax():
    jm, jconsts, tm, tconsts, X = _pre_loop_state("TSNE")
    Z0 = tm.init_embedding_
    w_Z, w_it, _ = jm._optimize(jnp.asarray(Z0.numpy()), jconsts, {})
    g_Z, g_it, _ = tm._optimize(Z0, tconsts, {})
    assert int(w_it) == g_it == 10
    np.testing.assert_allclose(g_Z.numpy(), np.asarray(w_Z), atol=1e-5, rtol=0)
    new = np.random.default_rng(9).normal(scale=4.0, size=(7, 8)).astype(np.float32)
    want = np.asarray(jm.transform(new))
    tm.is_fitted_ = True
    got = tm.transform(new)
    assert isinstance(got, np.ndarray) and got.shape == (7, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    as_tensor = tm.transform(torch.from_numpy(new))
    assert isinstance(as_tensor, torch.Tensor) and torch.equal(as_tensor, torch.from_numpy(got))


@pytest.mark.parametrize("model", ["UMAP", "TSNE", "LargeVis"])
def test_embedding_is_the_encoder_output(model):
    _, port_cls, kw = MODELS[model]
    X, _ = _blobs()
    m = port_cls(encoder=make_mlp_encoder(2, (16,)), max_iter=10, optimizer="Adam", lr=1e-3,
                 random_state=0, device="cpu", **kw)
    Z = m.fit_transform(X)
    assert Z.shape == (120, 2) and np.isfinite(Z).all() and m.n_iter_ == 10
    np.testing.assert_allclose(m.transform(X), Z, atol=1e-5, rtol=0)
    assert set(m.encoder_variables_) == {"layers.0.weight", "layers.0.bias", "layers.1.weight",
                                         "layers.1.bias"}


def test_same_seed_gives_the_same_fit():
    X, _ = _blobs()

    def run():
        return TSNE(perplexity=10, max_iter=10, optimizer="Adam", lr=1e-3, random_state=7,
                    encoder=make_mlp_encoder(2, (16,)), device="cpu").fit_transform(X)

    assert np.array_equal(run(), run())


def test_encoder_width_mismatch_raises():
    X, _ = _blobs()
    with pytest.raises(ValueError, match="n_components"):
        TSNE(perplexity=5, max_iter=5, encoder=make_mlp_encoder(3, (16,)), n_components=2,
             device="cpu").fit_transform(X)


def test_any_torch_module_serves_from_its_own_weights():
    """A module that is not an MLP starts from its parameters as they stand
    and is not changed by the fit."""
    X, _ = _blobs()
    torch.manual_seed(0)
    lin = torch.nn.Linear(8, 2)
    before = {k: v.detach().clone() for k, v in lin.named_parameters()}
    m = UMAP(n_neighbors=10, max_iter=5, optimizer="Adam", lr=1e-2, encoder=lin, random_state=0,
             device="cpu")
    m.fit_transform(X)
    assert all(torch.equal(before[k], v) for k, v in lin.named_parameters())
    assert not torch.equal(m.encoder_variables_["weight"], before["weight"])


def test_parametric_umap_quality():
    """tests/test_parametric.py's quality gate: silhouette above 0.15."""
    X, y = _blobs()
    Z = UMAP(n_neighbors=10, max_iter=300, optimizer="Adam", lr=1e-2, random_state=0,
             encoder=make_mlp_encoder(2, (64,)), device="cpu").fit_transform(X)
    assert silhouette_score(Z, y, device="cpu") > 0.15


def test_mlp_is_built_for_its_input_width():
    mlp = MLP((4, 2))
    assert len(mlp.layers) == 0
    mlp.build(6)
    assert [(lay.in_features, lay.out_features) for lay in mlp.layers] == [(6, 4), (4, 2)]


@pytest.mark.parametrize("model", ["UMAP", "TSNE"])
def test_encoder_runs_once_a_step(model):
    """One evaluation of the encoder on X a step, in the closed-form path
    (UMAP: Z, then dZ, then the VJP) and the autograd one (t-SNE), beside
    the init's and the final embedding's."""
    _, port_cls, kw = MODELS[model]
    X, _ = _blobs()
    enc = make_mlp_encoder(2, (16,))
    rows = []
    m = port_cls(encoder=enc, max_iter=7, optimizer="Adam", lr=1e-3, random_state=0,
                 device="cpu", **kw)
    enc.register_forward_hook(lambda mod, args, out: rows.append(args[0].shape[0]))
    m.fit_transform(X)
    assert m.n_iter_ == 7
    assert rows.count(X.shape[0]) == 7 + 2 and len(rows) == 7 + 3


@pytest.mark.parametrize("model", ["UMAP", "TSNE"])
def test_parametric_fit_on_a_mesh_keeps_its_weights_on_the_first_device(model):
    """On a 4-way CPU mesh the encoder's weights stay on the mesh's first
    device, as every piece of loop state does, and the fit is the one
    without the mesh (t-SNE's row-sharded repulsion sums the shards in rank
    order: 1e-5). SGD, since Adam's first step, g/|g| a component, turns a
    last-bit difference of a near-zero gradient into a step of lr."""
    from torchdr_tpu_torch.parallel import make_mesh

    _, port_cls, kw = MODELS[model]
    X, _ = _blobs()

    def fit(**mesh):
        m = port_cls(encoder=make_mlp_encoder(2, (16,)), max_iter=10, optimizer="SGD", lr=1e-2,
                     random_state=0, device="cpu", **kw, **mesh)
        return m, m.fit_transform(X)

    m, Z = fit(mesh=make_mesh(devices=["cpu"] * 4))
    _, want = fit()
    assert all(v.device == torch.device("cpu") for v in m.encoder_variables_.values())
    np.testing.assert_allclose(Z, want, atol=1e-5, rtol=0)

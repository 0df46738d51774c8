"""UMAP's ``bands`` edge schedule in the port against the JAX package's.

Both start from the JAX package's pre-loop state (UMAP affinity after
pruning, PCA init, exclusion sets). The schedule's state is compared
exactly: the per-row stable sort by fire period, the seven prefix widths
(0.98-quantiles of the rows' band counts, rounded up to 8, monotone, the
last the full width) and each column's visit period. The attraction and
its fire counts at steps 0 to 8 (each band's first visits, and step 0,
which takes the last band) are held at 1e-5 absolute, as the other
schedules' steps are in ``tests/test_torch_umap.py``. A small fit keeps
``TestBandSchedule``'s silhouette floor (0.8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.models.neighbor.umap import UMAP as JaxUMAP
from torchdr_tpu_torch import UMAP
from torchdr_tpu_torch.eval import silhouette_score
from torchdr_tpu_torch.utils.interop import load_reference_state


def _blobs():
    """tests/test_umap_features.py's blobs: 4 clusters of 60 rows in 10-D."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=8.0, size=(4, 10))
    X = np.concatenate([c + rng.normal(size=(60, 10)) for c in centers]).astype(np.float32)
    return X, np.repeat(np.arange(4), 60)


@pytest.fixture(scope="module")
def band_states():
    X, _ = _blobs()
    Xj = jnp.asarray(X)
    kw = dict(n_neighbors=12, max_iter=100, random_state=0, edge_schedule="bands")
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
    tm = UMAP(device="cpu", **kw)
    load_reference_state(tm, arrays)
    return jm, jm._build_consts(Xj), tm, tm._build_consts(None), arrays


def test_band_state_equals_jax(band_states):
    jm, jconsts, tm, tconsts, _ = band_states
    assert tconsts["edge_schedule"] == jconsts["edge_schedule"] == "bands"
    assert tconsts["band_widths"] == jconsts["band_widths"] == tm.band_widths_
    widths = tconsts["band_widths"]
    assert len(widths) == tm._N_BANDS == jm._N_BANDS == 7
    assert widths[-1] == tconsts["P"].shape[1] and list(widths) == sorted(widths)
    assert all(w % 8 == 0 or w == widths[-1] for w in widths)
    assert len(set(widths)) > 1  # the schedule does not degenerate to exact here
    for key in ("P", "NN", "epochs_per_sample", "band_period"):
        np.testing.assert_array_equal(tconsts[key].numpy(), np.asarray(jconsts[key]), err_msg=key)
    assert tconsts["edge_groups_G"] == 1 and tconsts["edge_group_width"] == 1


def test_band_prefixes_hold_their_bands(band_states):
    """TestBandSchedule's invariant: at most 2.1 % of rows have an edge of
    band ≤ z beyond prefix z."""
    _, _, tm, tconsts, _ = band_states
    eps = tconsts["epochs_per_sample"].numpy()
    band = np.where(np.isfinite(eps),
                    np.clip(np.floor(np.log2(np.maximum(eps, 1.0))), 0, tm._N_BANDS - 1),
                    tm._N_BANDS - 1)
    cols = np.arange(eps.shape[1])[None, :]
    for z, w in enumerate(tconsts["band_widths"]):
        assert np.any((cols >= w) & (band <= z), axis=1).mean() <= 0.021


@pytest.mark.parametrize("start", ["init", "spread"])
def test_band_attraction_at_steps_0_to_8_matches_jax(band_states, start):
    jm, jconsts, tm, tconsts, arrays = band_states
    n = arrays["init_embedding"].shape[0]
    Z = arrays["init_embedding"] if start == "init" else (
        3.0 * np.random.default_rng(1).normal(size=(n, 2))).astype(np.float32)
    for it in range(9):
        key = jax.random.PRNGKey(it)
        w_grad, w_carry = jm._attractive_gradients(jnp.asarray(Z), jconsts,
                                                   jm._init_carry(jconsts), it, key)
        g_grad, g_carry = tm._attractive_gradients(torch.from_numpy(Z), tconsts,
                                                   tm._init_carry(tconsts), it)
        assert g_carry["active_edges"].shape == (n, 1)
        np.testing.assert_array_equal(g_carry["active_edges"].numpy(),
                                      np.asarray(w_carry["active_edges"]), err_msg=f"step {it}")
        np.testing.assert_allclose(g_grad.numpy(), np.asarray(w_grad), atol=1e-5, rtol=0,
                                   err_msg=f"step {it}")


def test_bands_visit_the_prefix_of_the_step_s_trailing_zeros(band_states):
    """Step t fires only columns below band_widths[tz(t)] (step 0: the last
    band's, the full width)."""
    _, _, tm, tconsts, arrays = band_states
    widths = tconsts["band_widths"]
    seen = []
    orig = tm._attr_core

    def spy(Z, NN, eps, period, it, *rest):
        seen.append(NN.shape[1])
        return orig(Z, NN, eps, period, it, *rest)

    tm._attr_core = spy
    Z = torch.from_numpy(arrays["init_embedding"])
    for it in (0, 1, 2, 3, 4, 8, 12, 64, 96, 128):
        tm._attractive_gradients(Z, tconsts, tm._init_carry(tconsts), it)
    tz = [6, 0, 1, 0, 2, 3, 2, 6, 5, 6]
    assert seen == [widths[z] for z in tz]


def test_small_bands_fit_keeps_the_silhouette_floor():
    X, y = _blobs()
    Z = UMAP(n_neighbors=12, max_iter=300, random_state=0, edge_schedule="bands",
             device="cpu").fit_transform(X)
    assert np.isfinite(Z).all()
    assert silhouette_score(Z, y, device="cpu") > 0.8

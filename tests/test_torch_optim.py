"""The port's AdamW, NAdam, RiemannianAdam and fixed-step LBFGS against the
JAX package's, each from the same start on the same gradients.

Tolerances:

- the Adam family: 1e-5 absolute over a run that crosses a moment reset
  (JAX forms the bias correction 1 - b2**t in float32, the port in
  float64; ``tests/test_torch_umap.py::test_optimizer_matches_jax_across_reset``);
  AdamW also against ``torch.optim.AdamW`` in float64 at 1e-6. The JAX
  package's NAdam is Adam with a Nesterov first moment,
  b1·m̂ + (1 − b1)·g/(1 − b1^t), not ``torch.optim.NAdam``'s momentum
  schedule, so it is held to the JAX package only;
- RiemannianAdam: 20 steps of ``tests/test_optim.py``'s ball test, within
  1e-6 in float32 and 1e-12 in float64 (the port forms the bias
  corrections in float32, as the JAX package does), every point inside the
  ball;
- LBFGS: 60 fixed steps on the quadratic of ``tests/test_optim.py``
  (a float64 run at 1e-10, a float32 run at 1e-4 of the solution's scale),
  its residual below 1e-4 and 100 times below Adam's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import warm_worker_threads  # noqa: F401
from torchdr_tpu.utils.optim import make_optimizer as jax_make_optimizer
from torchdr_tpu_torch.utils.optim import make_optimizer

OPTIMIZERS = ["SGD", "Adam", "AdamW", "NAdam", "RiemannianAdam", "LBFGS"]


def _run_both(name, p0, grads, lr, hyper, reset_at=None, x64=False):
    """The JAX and the port's optimizer over ``grads`` from ``p0``."""
    jopt, topt = jax_make_optimizer(name), make_optimizer(name)
    with jax.enable_x64(x64):
        pj = jnp.asarray(p0)
        js = jopt.init(pj)
        for step, g in enumerate(grads):
            if step == reset_at:
                js = jopt.reset(js)
            pj, js = jopt.update(jnp.asarray(g), js, pj, lr, hyper)
        want = np.asarray(pj)
    pt = torch.from_numpy(p0.copy())
    ts = topt.init(pt)
    for step, g in enumerate(grads):
        if step == reset_at:
            ts = topt.reset(ts)
        pt, ts = topt.update(torch.from_numpy(g), ts, pt, lr, hyper)
    return pt.numpy(), want


@pytest.mark.parametrize("hyper", [{}, {"beta1": 0.8, "weight_decay": 0.05}], ids=["default", "set"])
@pytest.mark.parametrize("name", ["AdamW", "NAdam"])
def test_adam_family_matches_jax_across_reset(name, hyper):
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(40, 2)).astype(np.float32)
    grads = rng.normal(size=(8, 40, 2)).astype(np.float32)
    got, want = _run_both(name, p0, grads, 0.05, hyper, reset_at=5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_adamw_matches_torch_optim():
    """AdamW's default decay (1e-2) is torch.optim.AdamW's."""
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=(7,)) for _ in range(10)]
    p = torch.zeros(7, dtype=torch.float64, requires_grad=True)
    ref = torch.optim.AdamW([p], lr=0.05)
    topt = make_optimizer("AdamW")
    q = torch.zeros(7, dtype=torch.float64)
    state = topt.init(q)
    for g in grads:
        p.grad = torch.from_numpy(g)
        ref.step()
        q, state = topt.update(torch.from_numpy(g), state, q, 0.05, {})
    np.testing.assert_allclose(q.numpy(), p.detach().numpy(), atol=1e-6, rtol=0)


def _ball_run(dtype):
    """tests/test_optim.py's RiemannianAdam case as numpy: 20 points in the
    ball and 20 normal gradients."""
    p = 0.9 * np.asarray(jax.random.normal(jax.random.PRNGKey(0), (20, 2)), np.float64)
    p = p / (1.0 + np.linalg.norm(p, axis=1, keepdims=True))
    grads = [np.asarray(jax.random.normal(jax.random.PRNGKey(i), (20, 2)), np.float64)
             for i in range(20)]
    return p.astype(dtype), [g.astype(dtype) for g in grads]


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_riemannian_adam_matches_jax_and_stays_in_the_ball(x64):
    dtype = np.float64 if x64 else np.float32
    p0, grads = _ball_run(dtype)
    got, want = _run_both("RiemannianAdam", p0, grads, 0.1, {}, x64=x64)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_allclose(got, want, atol=1e-12 if x64 else 1e-6, rtol=0)
    assert np.linalg.norm(got, axis=1).max() < 1.0
    state = make_optimizer("RiemannianAdam").init(torch.from_numpy(p0))
    assert state["m"].shape == (20, 2) and state["v"].shape == (20, 1)


def test_riemannian_adam_near_the_boundary_matches_jax():
    """Points at the projection radius, where λ² reaches ~6e4: the same
    20 steps in float64."""
    p0, grads = _ball_run(np.float64)
    p0 = p0 / np.linalg.norm(p0, axis=1, keepdims=True) * (1 - 4e-3)
    got, want = _run_both("RiemannianAdam", p0, [10 * g for g in grads], 0.1, {}, x64=True)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    assert np.linalg.norm(got, axis=1).max() <= 1 - 4e-3 + 1e-12


def _quadratic(dtype):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(30, 30))
    A = (A @ A.T / 30 + np.eye(30)).astype(dtype)
    b = rng.normal(size=30).astype(dtype)
    return A, b


def _resid_run(name, lr, A, b, steps=60):
    opt = make_optimizer(name)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    x = torch.zeros(30, dtype=At.dtype)
    state = opt.init(x)
    for _ in range(steps):
        x, state = opt.update(At @ x - bt, state, x, lr, {})
    return x


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_lbfgs_matches_jax_on_the_quadratic(x64):
    """60 fixed steps of x ← x − H(Ax − b) against the JAX package's."""
    dtype = np.float64 if x64 else np.float32
    A, b = _quadratic(dtype)
    jopt = jax_make_optimizer("LBFGS")
    with jax.enable_x64(x64):
        Aj, bj = jnp.asarray(A), jnp.asarray(b)
        x = jnp.zeros(30, dtype)
        st = jopt.init(x)
        update = jax.jit(jopt.update)  # its two-loop fori_loops, traced once
        for _ in range(60):
            x, st = update(Aj @ x - bj, st, x, 1.0, {})
        want = np.asarray(x)
    got = _resid_run("LBFGS", 1.0, A, b).numpy()
    assert got.dtype == want.dtype == dtype
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=(1e-10 if x64 else 1e-4) * scale, rtol=0)


def test_lbfgs_solves_the_quadratic_and_beats_adam():
    A, b = _quadratic(np.float32)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    lbfgs = float(torch.linalg.vector_norm(At @ _resid_run("LBFGS", 1.0, A, b) - bt))
    adam = float(torch.linalg.vector_norm(At @ _resid_run("Adam", 0.1, A, b) - bt))
    assert lbfgs < 1e-4 and lbfgs < adam / 100


def test_lbfgs_takes_an_encoder_s_flat_vector_and_a_matrix_alike():
    """A (n, d) parameter runs the same steps as its flat vector."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.normal(size=(6, 2)))
    opt = make_optimizer("LBFGS")
    s1, s2 = opt.init(p), opt.init(p.reshape(-1))
    a, b = p, p.reshape(-1)
    for _ in range(4):
        a, s1 = opt.update(2.0 * a, s1, a, 0.3, {})
        b, s2 = opt.update(2.0 * b, s2, b, 0.3, {})
    assert a.shape == (6, 2) and torch.equal(a.reshape(-1), b)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_reset_matches_jax(name):
    """Every optimizer's reset after three steps: the moments (LBFGS: the
    curvature ring and the previous gradient) are zero and the step is 0,
    as in the JAX package; LBFGS keeps its previous point."""
    rng = np.random.default_rng(4)
    p0 = (0.3 * rng.normal(size=(10, 2))).astype(np.float32)
    grads = (0.1 * rng.normal(size=(3, 10, 2))).astype(np.float32)
    jopt, topt = jax_make_optimizer(name), make_optimizer(name)
    pj, js = jnp.asarray(p0), jopt.init(jnp.asarray(p0))
    pt, ts = torch.from_numpy(p0.copy()), topt.init(torch.from_numpy(p0.copy()))
    for g in grads:
        pj, js = jopt.update(jnp.asarray(g), js, pj, 0.1, {"momentum": 0.5})
        pt, ts = topt.update(torch.from_numpy(g), ts, pt, 0.1, {"momentum": 0.5})
    js, ts = jopt.reset(js), topt.reset(ts)
    assert set(ts) == set(js) and ts["step"] == int(js["step"]) == 0
    for key in set(ts) - {"step"}:
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), atol=1e-6, rtol=0,
                                   err_msg=key)
    assert all(not torch.any(ts[k]) for k in ("buf", "m", "v", "s", "y", "rho", "prev_g")
               if k in ts)


def test_unknown_optimizer_names_the_six():
    with pytest.raises(ValueError, match="not supported") as err:
        make_optimizer("Bogus")
    assert str(sorted(OPTIMIZERS)) in str(err.value)

"""The port's Poincaré-ball operations against the JAX package's.

Every function of ``torchdr_tpu_torch/utils/manifold.py`` takes the same
numpy inputs as its JAX counterpart, at curvatures 0.5, 1 and 2: within
1e-6 (relative and absolute) in float32, and 1e-12 in float64 (the JAX
function under ``jax.enable_x64``). Then the properties that
``tests/test_manifold.py`` holds the JAX package to, on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.utils import manifold as jm
from torchdr_tpu_torch.utils import manifold as tm

CURVATURES = [0.5, 1.0, 2.0]


def _points(seed, n=32, d=4, scale=0.3, dtype=np.float32):
    """Random points inside the ball (radius up to ``scale``)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return (x * scale * rng.uniform(0.1, 1.0, size=(n, 1))).astype(dtype)


def _cases(dtype):
    """(name, args, kwargs) of every function, on inputs of ``dtype``."""
    x, y = _points(0, dtype=dtype), _points(1, dtype=dtype)
    u, v = _points(2, scale=0.5, dtype=dtype), _points(3, scale=0.5, dtype=dtype)
    far = _points(4, scale=3.0, dtype=dtype)  # partly outside the ball
    s = np.linspace(-1.2, 1.2, 64).astype(dtype)
    t = np.linspace(-20.0, 20.0, 64).astype(dtype)
    return [
        ("lambda_x", (x,)), ("mobius_add", (x, y)), ("poincare_project", (far,)),
        ("poincare_expmap", (u, x)), ("poincare_expmap0", (u,)),
        ("poincare_logmap", (x, y)), ("poincare_logmap0", (x,)),
        ("poincare_sqdist", (x, y)), ("egrad2rgrad", (x, u)), ("_gyration", (x, y, u)),
        ("poincare_ptransp", (x, y, u)), ("poincare_inner", (x, u, v)),
        ("_artanh", (s,)), ("_tanh", (t,)),
    ]


_NAMES = [name for name, _ in _cases(np.float32)]
_CURVED = set(_NAMES) - {"_artanh", "_tanh"}


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("name", _NAMES)
def test_function_matches_jax(name, x64):
    dtype = np.float64 if x64 else np.float32
    tol = 1e-12 if x64 else 1e-6
    args = dict(_cases(dtype))[name]
    for c in CURVATURES if name in _CURVED else [None]:
        kw = {} if c is None else {"c": c}
        with jax.enable_x64(x64):
            want = np.asarray(getattr(jm, name)(*(jnp.asarray(a) for a in args), **kw))
        got = getattr(tm, name)(*(torch.from_numpy(a) for a in args), **kw).numpy()
        assert got.dtype == want.dtype == dtype
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=f"{name} c={c}")


def test_constants_are_the_jax_package_s():
    assert (tm.MIN_NORM, tm.BALL_EPS) == (jm.MIN_NORM, jm.BALL_EPS) == (1e-15, 4e-3)


def _t(seed, **kw):
    return torch.from_numpy(_points(seed, **kw))


@pytest.mark.parametrize("c", CURVATURES)
def test_mobius_group_laws(c):
    """0 is the identity, -x the left inverse, sums stay in the ball, and
    (-x) ⊕ (x ⊕ y) = y."""
    x, y = _t(0), _t(1)
    z = torch.zeros_like(x)
    assert torch.allclose(tm.mobius_add(x, z, c), x, atol=1e-6)
    assert torch.allclose(tm.mobius_add(z, x, c), x, atol=1e-6)
    assert tm.mobius_add(-x, x, c).abs().max() < 1e-5
    a, b = _t(2, scale=0.6), _t(3, scale=0.6)
    assert (tm.mobius_add(a, b, c).norm(dim=-1) < 1.0 / np.sqrt(c) + 1e-6).all()
    assert torch.allclose(tm.mobius_add(-x, tm.mobius_add(x, y, c), c), y, atol=1e-5)


@pytest.mark.parametrize("c", CURVATURES)
def test_exp_and_log_maps_invert(c):
    p, u = _t(6), _t(7, scale=0.5)
    assert torch.allclose(tm.poincare_expmap0(tm.poincare_logmap0(p, c), c), p, atol=1e-5)
    assert torch.allclose(tm.poincare_logmap0(tm.poincare_expmap0(u, c), c), u, atol=1e-5)
    p1, p2 = _t(8), _t(9)
    assert torch.allclose(tm.poincare_expmap(tm.poincare_logmap(p1, p2, c), p1, c), p2, atol=1e-4)
    assert torch.allclose(tm.poincare_expmap(torch.zeros_like(p1), p1, c), p1, atol=1e-6)


def test_tangent_norm_equals_distance():
    """‖logmap_p1(p2)‖ in p1's metric is d(p1, p2)."""
    p1, p2 = _t(11), _t(12)
    u = tm.poincare_logmap(p1, p2)
    riem = tm.poincare_inner(p1, u, u)[..., 0]
    assert torch.allclose(riem, tm.poincare_sqdist(p1, p2), rtol=1e-3)


def test_metric_properties():
    p1, p2, p3 = _t(13), _t(14), _t(15)
    assert torch.allclose(tm.poincare_sqdist(p1, p2), tm.poincare_sqdist(p2, p1), rtol=1e-4)
    assert tm.poincare_sqdist(p1, p1).abs().max() < 1e-6
    d = lambda a, b: torch.sqrt(tm.poincare_sqdist(a, b))  # noqa: E731
    assert (d(p1, p3) <= d(p1, p2) + d(p2, p3) + 1e-4).all()
    assert torch.allclose(tm.lambda_x(torch.zeros(3, 4)), torch.tensor(2.0))
    assert float(tm.lambda_x(torch.tensor([[0.999, 0.0]]))[0, 0]) > 100.0


def test_project_clips_to_the_ball_and_keeps_interior_points():
    x = torch.tensor([[2.0, 0.0], [0.0, -3.0], [0.1, 0.1]])
    out = tm.poincare_project(x)
    assert (out.norm(dim=-1) < 1.0).all()
    assert torch.equal(out[2], x[2])


@pytest.mark.parametrize("c", CURVATURES)
def test_transport_is_an_isometry(c):
    """⟨u, v⟩_x = ⟨Pu, Pv⟩_y, and transport from x to x is the identity."""
    x, y = _t(18), _t(19)
    u, v = _t(20, scale=0.5), _t(21, scale=0.5)
    lhs = tm.poincare_inner(x, u, v, c)
    rhs = tm.poincare_inner(y, tm.poincare_ptransp(x, y, u, c), tm.poincare_ptransp(x, y, v, c), c)
    assert torch.allclose(lhs, rhs, rtol=1e-3, atol=1e-5)
    assert torch.allclose(tm.poincare_ptransp(x, x, u, c), u, atol=1e-5)


def test_riemannian_descent_decreases_the_distance():
    """egrad2rgrad is 1/λ² scaling, and a Riemannian gradient flow on
    d²(p, target) by expmap steps moves p onto the target."""
    x, g = _t(24), _t(25)
    assert torch.allclose(tm.egrad2rgrad(x, g), g / tm.lambda_x(x) ** 2, rtol=1e-5)
    target, p0 = _t(26, n=8), _t(27, n=8)
    p = p0.clone()
    for _ in range(50):
        pg = p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(tm.poincare_sqdist(pg, target)), pg)
        p = tm.poincare_project(tm.poincare_expmap(-0.05 * tm.egrad2rgrad(p, g), p))
    assert torch.sum(tm.poincare_sqdist(p, target)) < 0.01 * torch.sum(
        tm.poincare_sqdist(p0, target)
    )

"""Root searches of the port against the JAX package's, and where their
brackets live.

``binary_search``, ``false_position`` and ``init_bounds`` take the device
of a tensor bound; without one, ``device="auto"`` is the CUDA card and
raises without it, and an explicit ``device="cpu"`` runs on the CPU. The
roots of f(x) = log x − log target agree with the JAX package's at 1e-5
relative (both iterate the same float32 arithmetic; the stop test every 8
iterations gives the every-iteration result bit for bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.ops import root_search as jrs
from torchdr_tpu_torch.ops import root_search as trs

SEARCHES = ["binary_search", "false_position"]


def _target(n=257, seed=5):
    return np.random.default_rng(seed).uniform(0.01, 50.0, n).astype(np.float32)


def _port_f(target):
    t = torch.from_numpy(target)
    return lambda x: torch.log(x) - torch.log(t.to(x.device))


@pytest.mark.parametrize("name", SEARCHES)
def test_roots_match_jax(name):
    target = _target()
    tj = jnp.asarray(target)
    want = np.asarray(getattr(jrs, name)(lambda x: jnp.log(x) - jnp.log(tj), target.size))
    got = getattr(trs, name)(_port_f(target), target.size, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, target, rtol=1e-4)


@pytest.mark.parametrize("name", SEARCHES)
def test_sync_interval_is_bit_identical(name):
    target = _target(seed=6)
    every = getattr(trs, name)(_port_f(target), target.size, device="cpu", sync_every=1)
    sparse = getattr(trs, name)(_port_f(target), target.size, device="cpu", sync_every=8)
    assert torch.equal(every, sparse)


@pytest.mark.parametrize("name", SEARCHES + ["init_bounds"])
def test_scalar_bounds_without_a_device_take_the_card(name):
    """The default ``device="auto"`` is the card: without one the call
    raises, as an estimator's ``device="auto"`` does, instead of running on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='auto' resolves to it")
    target = _target(n=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(trs, name)(_port_f(target), target.size)


@pytest.mark.parametrize("name", SEARCHES)
def test_tensor_bounds_give_their_device(name):
    """CPU tensor bounds put the brackets on the CPU with no ``device``;
    the roots are the JAX package's from the same bracket."""
    target = _target(n=64, seed=7)
    tj = jnp.asarray(target)
    begin, end = np.full(64, 0.5, np.float32), np.full(64, 2.0, np.float32)
    want = np.asarray(getattr(jrs, name)(lambda x: jnp.log(x) - jnp.log(tj), 64,
                                         begin=jnp.asarray(begin), end=jnp.asarray(end)))
    got = getattr(trs, name)(_port_f(target), 64, begin=torch.from_numpy(begin),
                             end=torch.from_numpy(end))
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_init_bounds_bracket_the_roots_like_jax():
    target = _target(n=32, seed=8)
    tj = jnp.asarray(target)
    wb, we = jrs.init_bounds(lambda x: jnp.log(x) - jnp.log(tj), 32)
    gb, ge = trs.init_bounds(_port_f(target), 32, device="cpu")
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    assert (gb.numpy() <= target).all() and (target <= ge.numpy()).all()

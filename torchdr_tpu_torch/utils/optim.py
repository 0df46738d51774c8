"""First-order optimizers with runtime hyperparameters.

Counterpart of ``torchdr_tpu/utils/optim.py``: an optimizer is an
``(init, update, reset)`` triple over one parameter tensor, whose learning
rate and momentum are arguments of each update, so a phase switch changes
an argument and "re-instantiating the optimizer" zeroes the moments.
Update semantics are torch.optim's (SGD: buf = g on the first step, then
μ·buf + g; Adam, AdamW and NAdam with torch's default betas and decoupled
weight decay from ``weight_decay``). The step counter is a Python int, so
no update reads the device.

``RiemannianAdam`` steps on the Poincaré ball: an (n, d) point array,
moved by the exponential map and projected back into the ball, its first
moment carried along by parallel transport. ``LBFGS`` is a fixed-step
two-loop recursion over a ring of curvature pairs, with invalid slots
masked by ``torch.where`` and no host read. Every optimizer also takes a
flat parameter vector, which is how the matcher passes an encoder's
weights. :func:`lbfgs_minimize` is the full L-BFGS solver with a
strong-Wolfe line search that the symmetric entropic affinity's LBFGS
branch calls.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from .manifold import egrad2rgrad, poincare_expmap, poincare_inner, poincare_project, poincare_ptransp


class OptimizerDef(NamedTuple):
    name: str
    init: Any  # params -> state
    update: Any  # (grad, state, params, lr, hyper) -> (new_params, new_state)
    reset: Any  # state -> state with moments zeroed


def _sgd_init(params: torch.Tensor) -> Dict:
    return {"buf": torch.zeros_like(params), "step": 0}


def _sgd_update(grad, state, params, lr, hyper):
    momentum = hyper.get("momentum", 0.0)
    buf = grad if state["step"] == 0 else momentum * state["buf"] + grad
    return params - lr * buf, {"buf": buf, "step": state["step"] + 1}


def _adam_init(params: torch.Tensor) -> Dict:
    return {"m": torch.zeros_like(params), "v": torch.zeros_like(params), "step": 0}


def _make_adam(weight_decay: float = 0.0, nesterov: bool = False):
    """Adam's update; AdamW's default decay and NAdam's Nesterov moment."""

    def update(grad, state, params, lr, hyper):
        b1 = hyper.get("beta1", 0.9)
        b2 = hyper.get("beta2", 0.999)
        eps = hyper.get("eps", 1e-8)
        wd = hyper.get("weight_decay", weight_decay)
        t = state["step"] + 1
        if wd:
            params = params * (1.0 - lr * wd)  # decoupled decay
        m = b1 * state["m"] + (1 - b1) * grad
        v = b2 * state["v"] + (1 - b2) * grad * grad
        m_hat = m / (1 - b1**t)
        if nesterov:
            m_hat = b1 * m_hat + (1 - b1) * grad / (1 - b1**t)
        v_hat = v / (1 - b2**t)
        new = params - lr * m_hat / (torch.sqrt(v_hat) + eps)
        return new, {"m": m, "v": v, "step": t}

    return update


def _reset(state: Dict) -> Dict:
    out = dict(state)
    for key in ("buf", "m", "v"):
        if key in out:
            out[key] = torch.zeros_like(out[key])
    out["step"] = 0
    return out


# --- Riemannian Adam on the Poincaré ball, over one (n, d) point array ---


def _radam_init(params: torch.Tensor) -> Dict:
    return {"m": torch.zeros_like(params), "v": torch.zeros_like(params[..., :1]), "step": 0}


def _radam_update(grad, state, point, lr, hyper):
    b1 = hyper.get("beta1", 0.9)
    b2 = hyper.get("beta2", 0.999)
    eps = hyper.get("eps", 1e-8)
    wd = hyper.get("weight_decay", 0.0)
    t = state["step"] + 1
    # the bias corrections in float32, as the JAX package's step counter is
    tf = torch.tensor(float(t), dtype=torch.float32)

    g = grad + wd * point
    rgrad = egrad2rgrad(point, g)
    m = b1 * state["m"] + (1 - b1) * rgrad
    v = b2 * state["v"] + (1 - b2) * poincare_inner(point, rgrad)
    denom = torch.sqrt(v) + eps
    step_size = lr * torch.sqrt(1 - b2**tf) / (1 - b1**tf)  # a CPU scalar tensor
    new_point = poincare_project(poincare_expmap(-step_size * (m / denom), point))
    m = poincare_ptransp(point, new_point, m)
    return new_point, {"m": m, "v": v, "step": t}


# --- L-BFGS: fixed step, fixed memory, no line search ---

_LBFGS_MEM = 10


def _lbfgs_init(params: torch.Tensor) -> Dict:
    flat = params.reshape(-1)
    d = flat.numel()
    return {
        "s": torch.zeros((_LBFGS_MEM, d), dtype=flat.dtype, device=flat.device),
        "y": torch.zeros((_LBFGS_MEM, d), dtype=flat.dtype, device=flat.device),
        "rho": torch.zeros((_LBFGS_MEM,), dtype=flat.dtype, device=flat.device),
        "prev_x": flat,
        "prev_g": torch.zeros_like(flat),
        "step": 0,
    }


def _lbfgs_update(grad, state, params, lr, hyper):
    """One fixed step ``x - lr · H g``: the pair of the previous step enters
    the ring when its curvature s·y exceeds 1e-10 (a device test, applied by
    ``torch.where``); the two-loop recursion skips empty slots."""
    flat, g = params.reshape(-1), grad.reshape(-1)
    m = _LBFGS_MEM
    step = state["step"]
    s_k = flat - state["prev_x"]
    y_k = g - state["prev_g"]
    sy = torch.dot(s_k, y_k)
    valid = (sy > 1e-10) & (step > 0)
    slot = max(step - 1, 0) % m

    def put(ring, row):
        new = ring.clone()
        new[slot] = row
        return torch.where(valid, new, ring)

    s_h, y_h = put(state["s"], s_k), put(state["y"], y_k)
    rho = put(state["rho"], 1.0 / torch.clamp(sy, min=1e-30))
    r = _two_loop(g, s_h, y_h, rho, slot, m)
    new_flat = flat - lr * r
    new_state = {"s": s_h, "y": y_h, "rho": rho, "prev_x": flat, "prev_g": g, "step": step + 1}
    return new_flat.reshape(params.shape), new_state


def _lbfgs_reset(state: Dict) -> Dict:
    """Zero the curvature ring and the previous gradient; keep ``prev_x``."""
    out = dict(state)
    for key in ("s", "y", "rho", "prev_g"):
        out[key] = torch.zeros_like(out[key])
    out["step"] = 0
    return out


_OPTIMIZERS = {
    "SGD": (_sgd_init, _sgd_update),
    "Adam": (_adam_init, _make_adam()),
    "AdamW": (_adam_init, _make_adam(weight_decay=1e-2)),
    "NAdam": (_adam_init, _make_adam(nesterov=True)),
    "RiemannianAdam": (_radam_init, _radam_update),
    "LBFGS": (_lbfgs_init, _lbfgs_update),
}


def make_optimizer(name: str) -> OptimizerDef:
    if name not in _OPTIMIZERS:
        raise ValueError(
            f"[TorchDR-Torch] ERROR: Optimizer '{name}' not supported. "
            f"Available: {sorted(_OPTIMIZERS)}."
        )
    init, update = _OPTIMIZERS[name]
    return OptimizerDef(name, init, update, _lbfgs_reset if name == "LBFGS" else _reset)


def normalize_optimizer_kwargs(kwargs: Dict | None) -> Dict:
    """Map torch-style kwarg names onto the runtime hyper dict."""
    if not kwargs:
        return {}
    out = dict(kwargs)
    if "betas" in out:
        b1, b2 = out.pop("betas")
        out["beta1"], out["beta2"] = b1, b2
    return out


# --- Full L-BFGS solver with strong-Wolfe line search ---
#
# Counterpart of the JAX package's ``lbfgs_minimize``, whose bracket/zoom
# search and outer iteration are ``lax.while_loop`` programs. Here both are
# Python loops that read a few scalars per trial; the arithmetic is the
# JAX package's, in the parameters' dtype.


def _ravel(params) -> Tuple[torch.Tensor, Callable]:
    """A tensor or a tuple of tensors as one flat vector, and its inverse."""
    if isinstance(params, torch.Tensor):
        shape = params.shape
        return params.reshape(-1), lambda flat: flat.reshape(shape)
    shapes = [p.shape for p in params]
    sizes = [p.numel() for p in params]
    flat = torch.cat([p.reshape(-1) for p in params])

    def unravel(v):
        return tuple(part.reshape(shape) for part, shape in zip(torch.split(v, sizes), shapes))

    return flat, unravel


def _wolfe_line_search(vag_d, f0, dphi0, t0, c1, c2, max_ls):
    """Strong-Wolfe step length on phi(t) = f(x + t*d).

    ``vag_d(t) -> (phi, dphi)`` evaluates the objective and the directional
    derivative at step ``t`` (0-d tensors). Bracketing by doubling, then
    zoom by bisection (Nocedal & Wright alg. 3.6); falls back to the best
    Armijo point seen (or the lowest-value trial) when Wolfe is not met in
    ``max_ls`` evaluations, and to ``t0`` when every trial diverged.
    """
    inf = torch.full_like(f0, float("inf"))
    zero = torch.zeros_like(f0)
    zoom = False
    t, t_prev, f_prev = t0, zero, f0
    t_lo, f_lo, t_hi = zero, f0, inf
    t_best, f_best = zero, inf
    for it in range(max_ls):
        phi, dphi = vag_d(t)
        armijo = bool(phi <= f0 + c1 * t * dphi0)
        wolfe = armijo and bool(torch.abs(dphi) <= -c2 * dphi0)
        # best-seen fallback: prefer Armijo points, else the lowest value
        if bool(torch.isinf(f_best)):
            better = bool(phi < f0)
        else:
            better = armijo and bool(phi < f_best)
        if better:
            t_best, f_best = t, phi
        if wolfe:
            return t
        if zoom:
            if not armijo or bool(phi >= f_lo):
                t_hi = t
            else:
                t_lo, f_lo, t_hi = t, phi, (t_lo if bool(dphi * (t_hi - t_lo) >= 0) else t_hi)
        else:
            hi_found = not armijo or (it > 0 and bool(phi >= f_prev))
            if hi_found:
                zoom, t_lo, f_lo, t_hi = True, t_prev, f_prev, t
            elif bool(dphi >= 0):  # slope turned up: the bracket is (t, t_prev)
                zoom, t_lo, f_lo, t_hi = True, t, phi, t_prev
        t_prev, f_prev = t, phi
        t = 0.5 * (t_lo + t_hi) if zoom else 2.0 * t
    return t_best if bool(t_best > 0) else t0


def _two_loop(g, s_h, y_h, rho, slot: int, m: int) -> torch.Tensor:
    """The L-BFGS two-loop recursion, most recent pair first; empty slots
    (rho = 0) are skipped."""
    q = g
    alphas = []
    for j in range(m):
        idx = (slot - j) % m
        a = rho[idx] * torch.dot(s_h[idx], q)
        a = torch.where(rho[idx] > 0, a, torch.zeros_like(a))
        q = q - a * y_h[idx]
        alphas.append(a)
    yy = torch.dot(y_h[slot], y_h[slot])
    gamma = torch.where(
        rho[slot] > 0, 1.0 / torch.clamp(rho[slot] * yy, min=1e-30), torch.ones_like(yy)
    )
    r = gamma * q
    for j in range(m):
        idx = (slot - (m - 1 - j)) % m
        b = rho[idx] * torch.dot(y_h[idx], r)
        r = torch.where(rho[idx] > 0, r + (alphas[m - 1 - j] - b) * s_h[idx], r)
    return r


def lbfgs_minimize(
    value_and_grad_fn,
    x0,
    max_iter: int = 100,
    memory: int = _LBFGS_MEM,
    tol: float = 1e-6,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_ls: int = 20,
):
    """Minimize ``f`` from ``x0`` (a tensor or a tuple of tensors) by L-BFGS
    with a strong-Wolfe line search.

    ``value_and_grad_fn(x) -> (f, grad)``, with ``grad`` shaped as ``x``.
    Returns ``(x, f, n_iter)``. Curvature pairs in a ring buffer of
    ``memory`` slots, the first step scaled by 1/||g||_1 as in
    ``torch.optim.LBFGS``, later steps starting at t = 1. Stops when
    max |g| <= tol, when f moves by at most 1e-12 max(1, |f|), or when a
    step fails to descend (the better iterate is kept).
    """
    flat0, unravel = _ravel(x0)
    m = int(memory)

    def vag_flat(xf):
        f, g = value_and_grad_fn(unravel(xf))
        return f.detach(), _ravel(g)[0].detach()

    x = flat0.detach()
    f, g = vag_flat(x)
    s_h = torch.zeros((m, x.numel()), dtype=x.dtype, device=x.device)
    y_h = torch.zeros_like(s_h)
    rho = torch.zeros((m,), dtype=x.dtype, device=x.device)
    done = bool(torch.max(torch.abs(g)) <= tol)
    k = 0
    while k < max_iter and not done:
        d = -_two_loop(g, s_h, y_h, rho, max(k - 1, 0) % m, m)
        dg = torch.dot(d, g)
        if bool(dg < 0):
            dphi0 = dg
        else:
            d, dphi0 = -g, -torch.dot(g, g)
        if k == 0:
            t0 = torch.clamp(1.0 / torch.clamp(torch.sum(torch.abs(g)), min=1e-30), max=1.0)
        else:
            t0 = torch.ones_like(f)

        def vag_d(t, x=x, d=d):
            ft, gt = vag_flat(x + t * d)
            return ft, torch.dot(gt, d)

        t = _wolfe_line_search(vag_d, f, dphi0, t0.to(f.dtype), c1, c2, max_ls)
        x_new = x + t * d
        f_new, g_new = vag_flat(x_new)

        s_k, y_k = x_new - x, g_new - g
        sy = torch.dot(s_k, y_k)
        if bool(sy > 1e-10):
            slot = k % m
            s_h[slot], y_h[slot] = s_k, y_k
            rho[slot] = 1.0 / torch.clamp(sy, min=1e-30)
        done = bool(torch.max(torch.abs(g_new)) <= tol) or bool(
            torch.abs(f_new - f) <= 1e-12 * torch.clamp(torch.abs(f), min=1.0)
        )
        k += 1
        if bool(f_new > f):  # the search failed to descend: keep the better iterate
            done = True
        else:
            x, f, g = x_new, f_new, g_new
    return unravel(x), f, k

"""First-order optimizers with runtime hyperparameters.

Counterpart of ``torchdr_tpu/utils/optim.py``: an optimizer is an
``(init, update, reset)`` triple over one parameter tensor, whose learning
rate and momentum are arguments of each update, so a phase switch changes
an argument and "re-instantiating the optimizer" zeroes the moments.
Update semantics are torch.optim's (SGD: buf = g on the first step, then
μ·buf + g; Adam with torch's default betas and decoupled weight decay from
``weight_decay``). The step counter is a Python int, so no update reads
the device. AdamW, NAdam, RiemannianAdam and LBFGS wait for a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch


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


def _adam_update(grad, state, params, lr, hyper):
    b1 = hyper.get("beta1", 0.9)
    b2 = hyper.get("beta2", 0.999)
    eps = hyper.get("eps", 1e-8)
    wd = hyper.get("weight_decay", 0.0)
    t = state["step"] + 1
    if wd:
        params = params * (1.0 - lr * wd)  # decoupled decay
    m = b1 * state["m"] + (1 - b1) * grad
    v = b2 * state["v"] + (1 - b2) * grad * grad
    m_hat = m / (1 - b1**t)
    v_hat = v / (1 - b2**t)
    new = params - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return new, {"m": m, "v": v, "step": t}


def _reset(state: Dict) -> Dict:
    out = dict(state)
    for key in ("buf", "m", "v"):
        if key in out:
            out[key] = torch.zeros_like(out[key])
    out["step"] = 0
    return out


_OPTIMIZERS = {
    "SGD": (_sgd_init, _sgd_update),
    "Adam": (_adam_init, _adam_update),
}


def make_optimizer(name: str) -> OptimizerDef:
    if name not in _OPTIMIZERS:
        raise ValueError(
            f"[TorchDR-Torch] ERROR: Optimizer '{name}' not supported. "
            f"Available: {sorted(_OPTIMIZERS)}."
        )
    init, update = _OPTIMIZERS[name]
    return OptimizerDef(name, init, update, _reset)


def normalize_optimizer_kwargs(kwargs: Dict | None) -> Dict:
    """Map torch-style kwarg names onto the runtime hyper dict."""
    if not kwargs:
        return {}
    out = dict(kwargs)
    if "betas" in out:
        b1, b2 = out.pop("betas")
        out["beta1"], out["beta2"] = b1, b2
    return out

"""Affinity matching engine — the generic "match P to Q" optimizer.

Counterpart of ``torchdr_tpu/affinity_matcher.py``. The JAX package runs
the whole optimization as one compiled ``lax.while_loop``; here it is a
Python loop over device tensors with the same per-step plan:

- the early-exaggeration coefficient, the momentum switch and the auto
  learning rate are functions of the step counter, evaluated on the host
  (the counter is a Python int, so they read nothing from the device);
- "re-instantiating the optimizer" at the end of early exaggeration is a
  zeroing of the moment buffers;
- sampling and schedule state lives in a ``carry`` dict passed from step
  to step; random draws come from the fit's root ``torch.Generator``;
- convergence (grad-norm < min_grad_norm) is tested every
  ``check_interval`` steps. Only those check steps read the device; no
  other step synchronises. With ``max_iters_per_dispatch`` the loop runs
  in segments of that many steps and waits for the device at the end of
  each; the result is the same.

Gradients come in closed form (``_gradients``, UMAP) or by autograd of a
scalar loss (``_loss``: t-SNE's and SNE's, or the generic loss between P
and ``affinity_out(Z)`` under ``loss_fn``): each step then takes
``torch.autograd.grad`` on a detached copy of Z that requires grad.

With ``encoder=`` (a ``torch.nn.Module``) the optimized parameters are
the encoder's weights as one flat vector, and Z is the encoder's output
on X, evaluated once a step through ``torch.func.functional_call``: the
autograd path differentiates the loss through it, the closed-form path
chains the gradient dZ into the weights by ``torch.autograd.grad(Z, θ,
dZ)``. ``transform`` of new rows is then the encoder's output at the
fitted weights (``encoder_variables_``).

``affinity_in="precomputed"`` takes X as the (n, n) input affinity.

A device mesh (``mesh=``, or ``distributed=True``/``"auto"``: every visible
CUDA device; "auto" only when there is more than one) is resolved before
the affinity phase and injected into the input affinity, whose kNN build
and symmetrization then run row-sharded over it. The loop's state (Z or
the encoder's weights, the optimizer's buffers, the affinity) lives on the
mesh's first device, where the JAX package row-shards it by GSPMD
placement hints; the explicitly sharded operations spread their work over
the mesh: t-SNE's and SNE's O(n²) repulsion, and UMAP's whole step (each
shard's rows' attraction and K1 repulsion on the shard's device, Z copied
out and the gradient gathered back each step; ``models/neighbor/umap.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch.func import functional_call

from .affinity.base import Affinity, LogAffinity, SparseAffinity
from .base import DRModule
from .ops.reductions import cross_entropy_loss, square_loss
from .parallel.mesh import check_mesh, make_mesh
from .utils.encoders import init_encoder_variables
from .utils.logger import log_phase
from .utils.manifold import poincare_expmap0
from .utils.optim import make_optimizer, normalize_optimizer_kwargs
from .utils.profiling import span, span_total
from .utils.schedulers import make_scheduler
from .utils.wrappers import full_float32, restore_format, to_torch

LOSS_DICT = {"square_loss": square_loss, "cross_entropy_loss": cross_entropy_loss}


class _FlatVariables:
    """An encoder's named weights as one flat vector, and back."""

    def __init__(self, variables: Dict[str, torch.Tensor]):
        self.names = list(variables)
        self.shapes = [v.shape for v in variables.values()]
        self.sizes = [v.numel() for v in variables.values()]

    @staticmethod
    def flatten(variables: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([v.reshape(-1) for v in variables.values()])

    def unflatten(self, theta: torch.Tensor) -> Dict[str, torch.Tensor]:
        parts = torch.split(theta, self.sizes)
        return {n: p.view(s) for n, p, s in zip(self.names, parts, self.shapes)}


class AffinityMatcher(DRModule):
    r"""Minimize a loss between input affinity P and embedding affinity Q.

    ``timings_`` holds the wall seconds of the last fit's spans, those on
    the device synchronised at their end: ``DRModule.fit_transform``'s
    ("fit", "api.check", "api.h2d", "api.dedup", "api.d2h"), and the phases
    "affinity" (the whole input affinity, kNN included), "knn" (the kNN
    build inside it; with ``knn_mode="ivf"`` on one device "knn.build",
    the index, and "knn.search"; on a mesh "knn.build", "knn.replicate",
    the index and queries copied to the other devices, and "knn.shards",
    the searches through to the gathered graph), "affinity.exchange" (on
    a mesh, a sparse affinity's edge exchange), "init" and "optimize", which holds
    "optimize.consts" (the loop's constants and first carry) and
    "optimize.loop" (the loop). "optimize.wait" is the part of the loop
    spent waiting on the device (the grad-norm reads of the check steps
    and each segment's closing synchronise); the rest of the loop is the
    host's issue of the steps. ``encoder`` takes a
    ``torch.nn.Module`` (e.g. ``utils.encoders.make_mlp_encoder``), whose
    weights are then optimized instead of a free embedding matrix.
    """

    _use_closed_form_gradients = False

    def __init__(
        self,
        affinity_in: Union[Affinity, str],
        affinity_out: Optional[Affinity] = None,
        kwargs_affinity_out: Optional[Dict] = None,
        n_components: int = 2,
        loss_fn: str = "square_loss",
        kwargs_loss: Optional[Dict] = None,
        optimizer: str = "Adam",
        optimizer_kwargs: Union[Dict, str, None] = None,
        lr: Union[float, str] = 1e0,
        scheduler: Optional[str] = None,
        scheduler_kwargs: Union[Dict, str, None] = None,
        min_grad_norm: float = 1e-7,
        max_iter: int = 1000,
        init: Union[str, np.ndarray, torch.Tensor] = "pca",
        init_scaling: float = 1e-4,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        check_interval: int = 50,
        distributed: Union[bool, str] = False,
        mesh=None,
        encoder=None,
        max_iters_per_dispatch: Optional[int] = None,
        **kwargs,
    ):
        super().__init__(
            n_components=n_components,
            device=device,
            verbose=verbose,
            random_state=random_state,
            **kwargs,
        )
        if loss_fn not in LOSS_DICT:
            raise ValueError(f"[TorchDR-Torch] ERROR : Loss function {loss_fn} not supported.")
        if not isinstance(affinity_in, Affinity) and affinity_in != "precomputed":
            raise ValueError(
                '[TorchDR-Torch] affinity_in must be an Affinity instance or "precomputed".'
            )
        if affinity_out is not None and not isinstance(affinity_out, Affinity):
            raise ValueError(
                "[TorchDR-Torch] ERROR : affinity_out must be an Affinity instance when not None."
            )
        self.affinity_in = affinity_in
        self.affinity_out = affinity_out
        self.kwargs_affinity_out = kwargs_affinity_out
        self.loss_fn = loss_fn
        self.kwargs_loss = kwargs_loss
        self.encoder = encoder
        self.max_iters_per_dispatch = max_iters_per_dispatch
        self.optimizer = optimizer
        self.optimizer_kwargs = optimizer_kwargs
        self.lr = lr
        self.scheduler = scheduler
        self.scheduler_kwargs = scheduler_kwargs
        self.min_grad_norm = min_grad_norm
        self.max_iter = max_iter
        self.init = init
        self.init_scaling = init_scaling
        self.check_interval = check_interval
        self.distributed = distributed
        self.mesh = check_mesh(mesh)

        # Early-exaggeration plan; overridden by NeighborEmbedding.
        self._ee_coeff = 1.0
        self._ee_iter = 0
        self.n_iter_ = -1

    # --- the device mesh ---

    def _resolve_mesh(self):
        """The fit's mesh, or None for one device: ``mesh`` when given, else
        every visible CUDA device when ``distributed`` is True, or "auto"
        with more than one visible."""
        if self.mesh is not None:
            return self.mesh
        if self.distributed == "auto":
            enabled = torch.cuda.device_count() > 1
        else:
            enabled = bool(self.distributed)
        return make_mesh() if enabled else None

    # --- fit ---

    @full_float32()
    def fit_transform(self, X, y: Optional[Any] = None):
        # rows of a precomputed affinity are not deduplicated
        if isinstance(self.affinity_in, str):
            self.process_duplicates = False
        return super().fit_transform(X, y)

    @full_float32()
    def transform(self, X=None):
        """The training embedding, or, with an encoder, its output on new rows
        at the fitted weights, in the caller's format."""
        if X is not None and self.encoder is not None:
            if not hasattr(self, "encoder_variables_"):
                raise ValueError("Estimator is not fitted yet.")
            Xt, fmt = to_torch(X, device=self.device_)
            with torch.no_grad():
                Z = functional_call(self.encoder, self.encoder_variables_, (Xt,))
            return restore_format(Z, fmt)
        return super().transform(X)

    def _fit_transform(self, X: torch.Tensor, y: Optional[Any] = None) -> torch.Tensor:
        self.n_samples_in_, self.n_features_in_ = X.shape
        self.device_ = X.device
        self._generator_ = self._root_generator()
        # the mesh is resolved before the affinity phase and injected into
        # the input affinity, so that its kNN build shards over it too
        self._fit_mesh_ = self._resolve_mesh()
        if isinstance(self.affinity_in, Affinity):
            self.affinity_in._set_fit_mesh(self._fit_mesh_)
        if self._fit_mesh_ is not None:
            self.logger.info(
                f"Fitting over a mesh of {len(self._fit_mesh_)} devices "
                f"(axis '{self._fit_mesh_.axis}'); the loop's state on {X.device}."
            )

        with log_phase(self.logger, "affinity", self.timings_, X.device):
            self.on_affinity_computation_start()
            self._compute_input_affinity(X)
            self.on_affinity_computation_end()
        if isinstance(self.affinity_in, Affinity):
            self.timings_.update(self.affinity_in._timings())

        with log_phase(self.logger, "init", self.timings_, X.device):
            Z0 = self._init_embedding(X)
        with log_phase(self.logger, "optimize", self.timings_, X.device):
            with span("consts", X.device, mesh=self._fit_mesh_):
                consts = self._build_consts(X)
                carry0 = self._init_carry(consts)
            Z, n_iter, grad_norm = self._optimize(Z0, consts, carry0)

        self.n_iter_ = int(n_iter)
        self._last_grad_norm_ = float(grad_norm)
        if bool(torch.isnan(Z).any()):
            raise ValueError("[TorchDR-Torch] ERROR AffinityMatcher : NaNs in the embeddings.")
        self.embedding_ = Z
        self.clear_memory()
        return Z

    def _compute_input_affinity(self, X: torch.Tensor) -> None:
        if isinstance(self.affinity_in, str):  # "precomputed"
            if X.shape[0] != X.shape[1]:
                raise ValueError(
                    '[TorchDR-Torch] ERROR : affinity_in="precomputed" requires X of '
                    "shape (n_samples, n_samples)."
                )
            if bool(torch.min(X) < 0):
                raise ValueError(
                    "[TorchDR-Torch] ERROR : precomputed affinity has negative entries."
                )
            self.affinity_in_ = X
            self.NN_indices_ = None
            return
        self.logger.info(f"Computing input affinity with {type(self.affinity_in).__name__}.")
        if isinstance(self.affinity_in, SparseAffinity):
            self.affinity_in_, self.NN_indices_ = self.affinity_in(X, return_indices=True)
        else:
            self.affinity_in_ = self.affinity_in(X)
            self.NN_indices_ = None

    # --- lifecycle hooks ---

    def on_affinity_computation_start(self):
        pass

    def on_affinity_computation_end(self):
        pass

    # --- consts / carry for the loop ---

    def _build_consts(self, X: torch.Tensor) -> Dict:
        """Device constants passed to every step."""
        consts = {"P": self.affinity_in_, "n": self.n_samples_in_}
        if self.NN_indices_ is not None:
            consts["NN"] = self.NN_indices_
        if self.encoder is not None:
            consts["X_encoder"] = X
        return consts

    def _init_carry(self, consts: Dict) -> Dict:
        return {}

    # --- embedding init ---

    def _init_embedding(self, X: torch.Tensor, draw=None) -> torch.Tensor:
        """The starting embedding. ``draw`` is the init's random draw when
        given: the (n, n_components) normal of "normal"/"random"/"hyperbolic",
        or, with an encoder, its starting weights by name; otherwise it comes
        from the fit's generator."""
        n = X.shape[0]
        if self.encoder is not None:
            # the optimized parameters are the encoder's weights; the
            # embedding is its output
            variables = draw if draw is not None else init_encoder_variables(
                self.encoder, X, self._generator_
            )
            variables = {k: torch.as_tensor(v).to(device=X.device, dtype=X.dtype)
                         for k, v in variables.items()}
            with torch.no_grad():
                Z0 = functional_call(self.encoder, variables, (X[:1],))
                if Z0.shape[-1] != self.n_components:
                    raise ValueError(
                        f"[TorchDR-Torch] encoder output dim ({Z0.shape[-1]}) != "
                        f"n_components ({self.n_components})."
                    )
                self._encoder_variables0_ = variables
                return functional_call(self.encoder, variables, (X,))

        def normal():
            if draw is not None:
                return torch.as_tensor(draw).to(device=X.device, dtype=X.dtype)
            return torch.randn((n, self.n_components), generator=self._generator_,
                               dtype=X.dtype, device=X.device)

        if isinstance(self.init, (np.ndarray, torch.Tensor)):
            emb = torch.as_tensor(self.init, dtype=X.dtype).to(X.device)
        elif self.init in ("normal", "random"):
            emb = normal()
        elif self.init == "pca":
            from .models.spectral.pca import PCA

            emb = PCA(n_components=self.n_components, device=X.device)._fit_transform(X)
        elif self.init == "hyperbolic":
            return poincare_expmap0(self.init_scaling * normal()).contiguous()
        else:
            raise ValueError(
                f"[TorchDR-Torch] ERROR : init {self.init} not supported in "
                f"{type(self).__name__}."
            )
        std0 = torch.std(emb[:, 0], correction=0)
        emb = self.init_scaling * emb / torch.where(std0 > 0, std0, torch.ones_like(std0))
        return emb.contiguous()  # row-major, as the kernels take it

    # --- schedules ---

    def _lr_plan(self):
        """(lr_during_ee, lr_after_ee) resolving lr='auto' (sklearn t-SNE rule)."""
        if self.lr == "auto":
            lr_ee = max(self.n_samples_in_ / max(self._ee_coeff, 1.0) / 4.0, 50.0)
            lr_post = max(self.n_samples_in_ / 4.0, 50.0)
            return float(lr_ee), float(lr_post)
        return float(self.lr), float(self.lr)

    def _momentum_plan(self):
        """(momentum_during_ee, momentum_after_ee) for 'auto' SGD kwargs."""
        if self.optimizer_kwargs == "auto":
            if self.optimizer == "SGD":
                return 0.5, 0.8
            return None, None
        kwargs = self.optimizer_kwargs or {}
        m = kwargs.get("momentum", 0.0)
        return m, m

    def _resolved_optimizer_kwargs(self):
        if self.optimizer_kwargs == "auto" or self.optimizer_kwargs is None:
            return {}
        return normalize_optimizer_kwargs(dict(self.optimizer_kwargs))

    def _scheduler_fn(self):
        skw = self.scheduler_kwargs
        if skw == "auto":
            skw = {"start_factor": 1.0, "end_factor": 0.0} if self.scheduler == "LinearLR" else None
        return make_scheduler(self.scheduler, skw)

    def _make_schedule(self):
        """``schedule(it) -> (ee_coeff, lr_t, hyper)``, all host values."""
        base_kwargs = self._resolved_optimizer_kwargs()
        lr_ee, lr_post = self._lr_plan()
        mom_ee, mom_post = self._momentum_plan()
        sched = self._scheduler_fn()
        ee_iter = self._ee_iter_resolved()
        max_iter = int(self.max_iter)
        ee_total = float(min(ee_iter, max_iter)) if ee_iter >= 0 else 1.0
        post_total = float(max_iter - max(ee_iter, 0)) if ee_iter >= 0 else float(max_iter)
        ee_coeff = float(self._ee_coeff)

        def schedule(it: int):
            in_ee = it <= ee_iter
            t_local = it if in_ee else it - (ee_iter + 1)
            total = ee_total if in_ee else post_total
            lr_t = (lr_ee if in_ee else lr_post) * sched(float(t_local), total)
            hyper = dict(base_kwargs)
            if mom_ee is not None:
                hyper["momentum"] = mom_ee if in_ee else mom_post
            return (ee_coeff if in_ee else 1.0), lr_t, hyper

        return schedule

    def _ee_iter_resolved(self) -> int:
        """Last early-exaggeration step, or -1 when there is none."""
        has_ee = self._ee_coeff > 1.0 and self._ee_iter > 0
        return int(self._ee_iter) if has_ee else -1

    # --- losses / gradients (overridden by subclasses) ---

    def _loss(self, Z, consts, carry, it, ee_coeff):
        """Scalar loss of the autograd path, ``(loss, carry)``: by default
        ``loss_fn`` between P and ``affinity_out(Z)``, in the log domain for
        a ``LogAffinity`` under the cross-entropy."""
        if self.affinity_out is None:
            raise ValueError(
                "[TorchDR-Torch] ERROR : affinity_out is not set. "
                "Set it or implement the _loss method."
            )
        kwargs_out = dict(self.kwargs_affinity_out or {})
        kwargs_loss = dict(self.kwargs_loss or {})
        if self.loss_fn == "cross_entropy_loss" and isinstance(self.affinity_out, LogAffinity):
            kwargs_out.setdefault("log", True)
            kwargs_loss.setdefault("log", True)
        Q = self.affinity_out(Z, **kwargs_out)
        return LOSS_DICT[self.loss_fn](consts["P"], Q, **kwargs_loss), carry

    def _gradients(self, Z, consts, carry, it, ee_coeff, neg_ids=None):
        raise NotImplementedError(
            "[TorchDR-Torch] ERROR : _gradients must be implemented when "
            "_use_closed_form_gradients is True."
        )

    def _loss_gradients(self, Z, consts, carry, it, ee_coeff):
        """dL/dZ of :meth:`_loss` by autograd, on a detached copy of Z."""
        Zg = Z.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, carry = self._loss(Zg, consts, carry, it, ee_coeff)
            (grad,) = torch.autograd.grad(loss, Zg)
        return grad, carry

    # --- the parametric path ---

    def _encoder_map(self, X: torch.Tensor):
        """(θ0, θ ↦ Z) for the encoder: its starting weights as one flat
        vector, and the map from such a vector to its output on X."""
        flat = _FlatVariables(self._encoder_variables0_)

        def to_Z(theta):
            return functional_call(self.encoder, flat.unflatten(theta), (X,))

        self._encoder_flat_ = flat
        return _FlatVariables.flatten(self._encoder_variables0_), to_Z

    def _encoder_gradients(self, to_Z, theta, consts, carry, it, ee_coeff):
        """dL/dθ through the encoder, which is evaluated once: by autograd
        of the loss, or, for closed-form gradients, dZ chained into θ by
        ``torch.autograd.grad(Z, θ, dZ)``."""
        theta = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            Z = to_Z(theta)
            if self._use_closed_form_gradients:
                dZ, carry = self._gradients(Z.detach(), consts, carry, it, ee_coeff)
                (grad,) = torch.autograd.grad(Z, theta, grad_outputs=dZ)
            else:
                loss, carry = self._loss(Z, consts, carry, it, ee_coeff)
                (grad,) = torch.autograd.grad(loss, theta)
        return grad, carry

    # --- the optimization loop ---

    def _optimize(self, Z0: torch.Tensor, consts: Dict, carry0: Dict):
        waiting = span_total("wait")
        with span("loop", Z0.device):
            if self.encoder is not None:
                params, to_Z = self._encoder_map(consts["X_encoder"])

                def gradients(theta, consts, carry, it, coeff):
                    return self._encoder_gradients(to_Z, theta, consts, carry, it, coeff)
            else:
                params, to_Z = Z0, None
                gradients = (
                    self._gradients if self._use_closed_form_gradients else self._loss_gradients
                )
            opt = make_optimizer(self.optimizer)
            schedule = self._make_schedule()
            ee_iter = self._ee_iter_resolved()
            check_interval = int(self.check_interval)
            min_grad_norm = float(self.min_grad_norm)
            max_iter = int(self.max_iter)
            segment = max(1, int(self.max_iters_per_dispatch or max_iter))

            opt_state, carry = opt.init(params), carry0
            grad_norm = float("inf")
            n_iter, done = 0, False
            while n_iter < max_iter and not done:
                for it in range(n_iter, min(n_iter + segment, max_iter)):
                    coeff, lr_t, hyper = schedule(it)
                    if ee_iter >= 0 and it == ee_iter + 1:
                        # the reference re-creates the optimizer after step ee_iter
                        opt_state = opt.reset(opt_state)
                    grad, carry = gradients(params, consts, carry, it, coeff)
                    params, opt_state = opt.update(grad, opt_state, params, lr_t, hyper)
                    n_iter = it + 1
                    if it % check_interval == 0:
                        # the only host read of a segment's steps
                        with waiting:
                            grad_norm = float(torch.linalg.vector_norm(grad))
                        if grad_norm < min_grad_norm:
                            done = True
                            break
                if params.is_cuda:
                    with waiting:
                        torch.cuda.synchronize(params.device)  # the end of a segment
            self._final_carry_ = carry
            if to_Z is None:
                return params, n_iter, grad_norm
            self.encoder_variables_ = {
                k: v.detach() for k, v in self._encoder_flat_.unflatten(params).items()
            }
            with torch.no_grad():
                return to_Z(params), n_iter, grad_norm

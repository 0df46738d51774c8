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
  other step synchronises.

Gradients come in closed form (``_gradients``, UMAP) or by autograd of a
scalar loss (``_loss``, t-SNE and SNE): each step then takes
``torch.autograd.grad`` on a detached copy of Z that requires grad.

A device mesh (``mesh=``, or ``distributed=True``/``"auto"``: every visible
CUDA device; "auto" only when there is more than one) is resolved before
the affinity phase and injected into the input affinity, whose kNN build
and symmetrization then run row-sharded over it. The loop's state (Z, the
optimizer's buffers, the affinity) lives on the mesh's first device, where
the JAX package row-shards it by GSPMD placement hints; the explicitly
sharded operations (t-SNE's and SNE's O(n²) repulsion) spread their work
over the mesh. The generic ``affinity_out`` loss (``affinity_out``,
``kwargs_affinity_out``, ``loss_fn``, ``kwargs_loss``), ``affinity_in=
"precomputed"``, parametric encoders (``encoder``) and bounded dispatches
(``max_iters_per_dispatch``) wait for ROADMAP item 21: the constructor takes
them with the JAX package's defaults and raises ``NotImplementedError`` for
any other value.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .affinity.base import Affinity, SparseAffinity
from .base import DRModule
from .parallel.mesh import check_mesh, make_mesh
from .utils.logger import log_phase
from .utils.optim import make_optimizer, normalize_optimizer_kwargs
from .utils.schedulers import make_scheduler

#: the JAX package's loss functions of the generic ``affinity_out`` path
LOSS_FNS = ("square_loss", "cross_entropy_loss")


def _not_ported(option: str) -> NotImplementedError:
    return NotImplementedError(
        f"[TorchDR-Torch] ERROR : {option} is not ported yet (ROADMAP item 21)."
    )


class AffinityMatcher(DRModule):
    r"""Minimize a loss between input affinity P and embedding affinity Q.

    ``timings_`` holds the wall time of the last fit's phases: "knn" (the
    kNN build inside the affinity), "affinity" (the whole input affinity,
    kNN included), "init" and "optimize".
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
        if loss_fn not in LOSS_FNS:
            raise ValueError(f"[TorchDR-Torch] ERROR : Loss function {loss_fn} not supported.")
        if affinity_in == "precomputed":
            raise _not_ported('affinity_in="precomputed"')
        if not isinstance(affinity_in, Affinity):
            raise ValueError(
                '[TorchDR-Torch] affinity_in must be an Affinity instance or "precomputed".'
            )
        for option, value, default in (
            ("affinity_out", affinity_out, None),
            ("kwargs_affinity_out", kwargs_affinity_out, None),
            ("loss_fn", loss_fn, "square_loss"),
            ("kwargs_loss", kwargs_loss, None),
            ("encoder", encoder, None),
            ("max_iters_per_dispatch", max_iters_per_dispatch, None),
        ):
            if value != default:
                raise _not_ported(f"{option}={value!r}")
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

    def _fit_transform(self, X: torch.Tensor, y: Optional[Any] = None) -> torch.Tensor:
        self.n_samples_in_, self.n_features_in_ = X.shape
        self.device_ = X.device
        self._generator_ = self._root_generator()
        self.timings_ = {}
        # the mesh is resolved before the affinity phase and injected into
        # the input affinity, so that its kNN build shards over it too
        self._fit_mesh_ = self._resolve_mesh()
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
        self.timings_.update(self.affinity_in._timings())

        with log_phase(self.logger, "init", self.timings_, X.device):
            Z0 = self._init_embedding(X)
        with log_phase(self.logger, "optimize", self.timings_, X.device):
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
        return consts

    def _init_carry(self, consts: Dict) -> Dict:
        return {}

    # --- embedding init ---

    def _init_embedding(self, X: torch.Tensor) -> torch.Tensor:
        n = X.shape[0]
        if isinstance(self.init, (np.ndarray, torch.Tensor)):
            emb = torch.as_tensor(self.init, dtype=X.dtype).to(X.device)
        elif self.init in ("normal", "random"):
            emb = torch.randn(
                (n, self.n_components), generator=self._generator_, dtype=X.dtype,
                device=X.device,
            )
        elif self.init == "pca":
            from .models.spectral.pca import PCA

            emb = PCA(n_components=self.n_components, device=X.device)._fit_transform(X)
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
        """Scalar loss of the autograd path: ``(loss, carry)``."""
        raise NotImplementedError(
            "[TorchDR-Torch] ERROR : _loss must be implemented; the generic "
            "affinity_out loss is not ported yet."
        )

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

    # --- the optimization loop ---

    def _optimize(self, Z0: torch.Tensor, consts: Dict, carry0: Dict):
        gradients = (
            self._gradients if self._use_closed_form_gradients else self._loss_gradients
        )
        opt = make_optimizer(self.optimizer)
        schedule = self._make_schedule()
        ee_iter = self._ee_iter_resolved()
        check_interval = int(self.check_interval)
        min_grad_norm = float(self.min_grad_norm)

        Z, opt_state, carry = Z0, opt.init(Z0), carry0
        grad_norm = float("inf")
        n_iter = 0
        for it in range(int(self.max_iter)):
            coeff, lr_t, hyper = schedule(it)
            if ee_iter >= 0 and it == ee_iter + 1:
                # the reference re-creates the optimizer after step ee_iter
                opt_state = opt.reset(opt_state)
            grad, carry = gradients(Z, consts, carry, it, coeff)
            Z, opt_state = opt.update(grad, opt_state, Z, lr_t, hyper)
            n_iter = it + 1
            if it % check_interval == 0:
                # the only host read of the loop
                grad_norm = float(torch.linalg.vector_norm(grad))
                if grad_norm < min_grad_norm:
                    break
        self._final_carry_ = carry
        return Z, n_iter, grad_norm

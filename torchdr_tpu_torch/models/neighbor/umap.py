"""UMAP (counterpart of ``torchdr_tpu/models/neighbor/umap.py``).

Closed-form gradients. The per-edge ``epochs_per_sample`` update schedule
is a closed form of the step counter: the visits of an edge slice happen
on a fixed period, so the catch-up burst at step ``it`` is
floor(now/eps) − floor((now−period)/eps), with no carried state. The
repulsion draws one shared negative sample per step and, for embedding
widths up to 8, goes through K1 (``ops/cuda/umap_kernel.py``): the Hopper
kernel on a CUDA tensor, its plain version on a CPU tensor.

Edge schedules: ``exact`` visits every edge every step; ``groups`` deals
the columns round-robin into G groups and visits group t % G at step t;
``bands`` (opt-in) sorts each row's edges by fire period and visits at
step t the row prefix that holds every power-of-two band b with
t % 2^b == 0. The prefix widths are host integers, so a step slices a
rectangle of the edge arrays; the repulsion is K1 in every schedule.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Union

import numpy as np
import torch

from ...affinity.knn_normalized import UMAPAffinity
from ...ops.cuda.umap_kernel import MAX_D, fused_shared_repulsion
from .base import NegativeSamplingNeighborEmbedding


def _div(x: float, t: torch.Tensor) -> torch.Tensor:
    """x / t rounded as one IEEE division (torch's ``float / Tensor`` is
    ``t.reciprocal() * x``, which rounds twice)."""
    return torch.div(torch.tensor(x, dtype=t.dtype), t)


def find_ab_params(spread: float, min_dist: float):
    """Fit (a, b) of the output kernel 1/(1 + a d^{2b}) to the offset
    exponential, as in the UMAP reference implementation."""
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.zeros(xv.shape)
    yv[xv < min_dist] = 1.0
    yv[xv >= min_dist] = np.exp(-(xv[xv >= min_dist] - min_dist) / spread)
    params, _ = curve_fit(curve, xv, yv)
    return float(params[0]), float(params[1])


class UMAP(NegativeSamplingNeighborEmbedding):
    """UMAP (McInnes et al. 2018; Damrich & Hamprecht 2021 formulation).

    Loss: -Σ_ij P_ij log Q_ij + Σ_{i, j ∈ Neg(i)} log(1 - Q_ij) with
    Q_ij = (1 + a d²ᵇ)⁻¹, optimized with closed-form gradients and the
    per-edge epochs_per_sample schedule.
    """

    _use_closed_form_gradients = True

    def __init__(
        self,
        n_neighbors: float = 30,
        n_components: int = 2,
        min_dist: float = 0.1,
        spread: float = 1.0,
        a: Optional[float] = None,
        b: Optional[float] = None,
        lr: float = 1e0,
        optimizer: str = "SGD",
        optimizer_kwargs: Union[Dict, str, None] = None,
        scheduler: Optional[str] = "LinearLR",
        scheduler_kwargs: Union[Dict, str, None] = "auto",
        init: str = "pca",
        init_scaling: float = 1e-4,
        min_grad_norm: float = 1e-7,
        max_iter: int = 1000,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        max_iter_affinity: int = 100,
        metric: str = "sqeuclidean",
        negative_sample_rate: int = 5,
        check_interval: int = 50,
        knn_mode: str = "exact",
        knn_precision: str = "highest",
        max_graph_degree: Optional[int] = None,
        discard_NNs: bool = False,
        shared_negatives: bool = True,
        n_shared_negatives: Optional[int] = None,
        edge_groups: Union[int, str] = "auto",
        edge_schedule: str = "auto",
        **kwargs,
    ):
        self.n_neighbors = n_neighbors
        self.min_dist = min_dist
        self.spread = spread
        self.metric = metric
        self.max_iter_affinity = max_iter_affinity
        self.negative_sample_rate = negative_sample_rate
        self.edge_groups = edge_groups
        self.edge_schedule = edge_schedule
        self._eps = 1e-3

        if a is None or b is None:
            a, b = find_ab_params(spread, min_dist)
        self._a = a
        self._b = b

        self.knn_mode = knn_mode
        self.knn_precision = knn_precision
        # Cap the symmetrized graph's width at the strongest
        # ``max_graph_degree`` edges per row (default 4·n_neighbors).
        self.max_graph_degree = (
            int(max_graph_degree) if max_graph_degree is not None else 4 * int(n_neighbors)
        )

        affinity_in = UMAPAffinity(
            n_neighbors=n_neighbors,
            metric=metric,
            max_iter=max_iter_affinity,
            device=device,
            verbose=verbose,
            sparsity=True,
            knn_mode=knn_mode,
            knn_precision=knn_precision,
            max_degree=self.max_graph_degree,
        )
        super().__init__(
            affinity_in=affinity_in,
            n_components=n_components,
            optimizer=optimizer,
            optimizer_kwargs=optimizer_kwargs,
            min_grad_norm=min_grad_norm,
            max_iter=max_iter,
            lr=lr,
            scheduler=scheduler,
            scheduler_kwargs=scheduler_kwargs,
            init=init,
            init_scaling=init_scaling,
            device=device,
            verbose=verbose,
            random_state=random_state,
            check_interval=check_interval,
            discard_NNs=discard_NNs,
            n_negatives=int(negative_sample_rate * n_neighbors),
            shared_negatives=shared_negatives,
            n_shared_negatives=n_shared_negatives,
            **kwargs,
        )

    def on_affinity_computation_end(self):
        """Drop dead edges (P ≤ max(P)/max_iter, which never fire) and cap
        the width at ``max_graph_degree``, strongest edges first."""
        P = self.affinity_in_
        NN = self.NN_indices_
        threshold = torch.max(P) / self.max_iter
        keep = (P > threshold) & (NN >= 0)
        kept = int(torch.max(torch.sum(keep, dim=1)))
        k_new = max(8, -(-kept // 8) * 8)
        k_new = min(k_new, max(8, -(-self.max_graph_degree // 8) * 8))
        if k_new < P.shape[1]:
            self.logger.info(
                f"Pruning affinity width {P.shape[1]} -> {k_new} "
                f"(threshold + max_graph_degree={self.max_graph_degree})."
            )
            zero = torch.zeros_like(P)
            order = torch.argsort(-torch.where(keep, P, zero), dim=1, stable=True)[:, :k_new]
            keep_s = torch.gather(keep, 1, order)
            self.affinity_in_ = torch.where(keep_s, torch.gather(P, 1, order), zero[:, :k_new])
            self.NN_indices_ = torch.where(
                keep_s, torch.gather(NN, 1, order), torch.full_like(order, -1).to(NN.dtype)
            )
        super().on_affinity_computation_end()

    def _edge_groups_for(self, n: int) -> int:
        """``edge_groups="auto"``: 12 groups from n = 500k, 4 from 50k, else 1."""
        if self.edge_groups == "auto":
            if n >= 500_000:
                return 12
            return 4 if n >= 50_000 else 1
        return max(1, int(self.edge_groups))

    def _edge_schedule_for(self, n: int) -> str:
        """``edge_schedule="auto"``: "groups" when G > 1, else "exact"."""
        if self.edge_schedule == "auto":
            return "groups" if self._edge_groups_for(n) > 1 else "exact"
        if self.edge_schedule not in ("bands", "groups", "exact"):
            raise ValueError(
                f"[TorchDR-Torch] ERROR : unknown edge_schedule "
                f"'{self.edge_schedule}' (bands | groups | exact | auto)."
            )
        if self.edge_schedule != "groups" and self.edge_groups != "auto":
            warnings.warn(
                f"[TorchDR-Torch] edge_groups={self.edge_groups!r} is ignored "
                f"with edge_schedule='{self.edge_schedule}' (groups only "
                f"apply to the 'groups' schedule).",
                UserWarning,
                stacklevel=2,
            )
        return self.edge_schedule

    def _shared_negative_count(self, n: int) -> int:
        if self.n_shared_negatives is not None:
            return int(self.n_shared_negatives)
        # S=512 at 60k+ keeps the (n, S) work cheap; small n keeps the base
        # class's wider sample.
        if n > 20_000:
            return 512
        return super()._shared_negative_count(n)

    #: number of power-of-two bands; the weakest band is visited every
    #: 2^(N_BANDS-1) = 64 steps
    _N_BANDS = 7

    def _band_consts(self, consts, P, NN):
        """The bands schedule's state: each row's edges sorted by fire period
        (stable), the prefix width of each band and each column's visit
        period 2^z_first(col), z_first(col) the first band whose prefix
        holds the column."""
        A_max = torch.max(P)
        small = P <= A_max / self.max_iter  # also covers the -1 pads (P == 0)
        eps = torch.where(small, torch.full_like(P, float("inf")), A_max / (P + 1e-3))
        order = torch.argsort(eps, dim=1, stable=True)
        eps = torch.gather(eps, 1, order)
        consts["P"] = torch.gather(P, 1, order)
        # gather-safe indices: dead/pad edges (eps=inf -> c=0) add nothing
        consts["NN"] = torch.clamp(torch.gather(NN, 1, order), min=0)
        consts["epochs_per_sample"] = eps
        band = torch.clamp(torch.floor(torch.log2(torch.clamp(eps, min=1.0))), 0, self._N_BANDS - 1)
        band = torch.where(torch.isfinite(eps), band, torch.full_like(band, self._N_BANDS - 1))
        W_full = P.shape[1]
        # 0.98-quantiles of the rows' band counts, not their maximum: one
        # hub row would otherwise widen every prefix to the full width. A
        # row past the quantile has its edges beyond a prefix visited with a
        # deeper band, and the catch-up burst keeps the total impulse exact.
        widths = []
        for z in range(self._N_BANDS):
            counts = torch.sum(band <= z, dim=1).to(torch.float32)
            w = int(torch.quantile(counts, 0.98))
            w = min(W_full, max(8, -(-w // 8) * 8))
            if widths:
                w = max(w, widths[-1])
            widths.append(w)
        widths[-1] = W_full  # every edge rides the last prefix
        consts["band_widths"] = tuple(widths)
        self.band_widths_ = tuple(widths)
        zf = np.full(W_full, self._N_BANDS - 1)
        for z in reversed(range(self._N_BANDS)):
            zf = np.where(np.arange(W_full) < widths[z], z, zf)
        consts["band_period"] = torch.from_numpy((2.0**zf)[None, :].astype(np.float32)).to(P.device)
        consts["edge_groups_G"] = 1
        consts["edge_group_width"] = 1  # active_edges carries row sums
        exp_w = sum(widths[z] * 2.0 ** -(z + 1) for z in range(self._N_BANDS - 1))
        exp_w += widths[-1] * 2.0 ** -(self._N_BANDS - 1)
        self.logger.info(
            f"Band schedule widths {list(widths)} "
            f"(expected gather width/step {exp_w:.1f} of {W_full})."
        )
        return consts

    def _build_consts(self, X):
        consts = super()._build_consts(X)
        P = self.affinity_in_
        NN = self.NN_indices_.long()

        sched = self._edge_schedule_for(P.shape[0])
        consts["edge_schedule"] = sched
        if sched == "bands":
            return self._band_consts(consts, P, NN)
        G = self._edge_groups_for(P.shape[0]) if sched == "groups" else 1
        consts["edge_groups_G"] = G
        W = P.shape[1]
        if G > 1:
            # Rotating edge groups: step t touches only the columns of group
            # t % G. Columns are dealt round-robin (rows are sorted strongest
            # first by the pruning), stacked (G, n, W); fire events missed
            # between visits are applied as catch-up bursts.
            k = P.shape[1]
            W = -(-k // G)
            pad = G * W - k
            n_rows = P.shape[0]
            if pad:
                P = torch.cat([P, torch.zeros((n_rows, pad), dtype=P.dtype, device=P.device)], 1)
                NN = torch.cat([NN, torch.full((n_rows, pad), -1, dtype=NN.dtype, device=NN.device)], 1)
            P = P.reshape(n_rows, W, G).permute(2, 0, 1).contiguous()
            NN = NN.reshape(n_rows, W, G).permute(2, 0, 1).contiguous()
            consts["P"] = P
        # gather-safe indices: dead/pad edges (eps=inf -> c=0) add nothing
        consts["NN"] = torch.clamp(NN, min=0)
        consts["edge_group_width"] = W

        A_max = torch.max(P)
        small = P <= A_max / self.max_iter  # also covers the -1 pads (P == 0)
        consts["epochs_per_sample"] = torch.where(
            small, torch.full_like(P, float("inf")), A_max / (P + 1e-3)
        )
        return consts

    def _init_carry(self, consts):
        carry = super()._init_carry(consts)
        # attraction computes per-edge fire counts; repulsion consumes them
        P = consts["P"]
        carry["active_edges"] = torch.zeros(
            (consts["n"], consts["edge_group_width"]), dtype=torch.float32, device=P.device
        )
        return carry

    # --- closed-form gradients ---

    def _attr_core(self, Z, NN, eps, period, it: int):
        """Closed-form attraction over one (n, W) edge slice.

        Returns (grad, per-edge fire counts c). The catch-up burst at step
        ``it`` is the number of fire events k·eps in (now−period, now]:
        floor(now/eps) − floor(max(now−period, 0)/eps). ``period`` is the
        slice's visit period: a float, or a (1, W) tensor of per-column
        periods (the bands schedule). Dead/pad edges carry eps=inf, so
        now/inf = 0 gives c = 0 with no masking.
        """
        diff = Z[:, None, :] - Z[NN]
        D = torch.sum(diff * diff, dim=-1)
        t = D**self._b
        coef = 2.0 * self._a * self._b * t / (torch.clamp(D, min=1e-20) * (1.0 + self._a * t))
        coef = torch.where(D > 0, coef, torch.zeros_like(coef))

        now = float(it + 1)
        if isinstance(period, torch.Tensor):
            prev = torch.clamp(now - period, min=0.0)
            c = torch.floor(_div(now, eps)) - torch.floor(prev / eps)
        else:
            c = torch.floor(_div(now, eps)) - torch.floor(_div(max(now - period, 0.0), eps))
        coef = coef * c
        grad = torch.clamp(torch.sum(diff * coef[:, :, None], dim=1), -4.0, 4.0)
        return grad, c

    def _attractive_gradients_bands(self, Z, consts, carry, it):
        """Step ``it`` visits the row prefix of width
        band_widths[trailing_zeros(it)] (step 0 the last band's): every band
        b with it % 2^b == 0. A column is visited on a fixed period, its
        first band's, so _attr_core's burst count applies."""
        widths = consts["band_widths"]
        tz = (it & -it).bit_length() - 1 if it > 0 else len(widths) - 1
        W = widths[min(tz, len(widths) - 1)]
        grad, c = self._attr_core(
            Z, consts["NN"][:, :W], consts["epochs_per_sample"][:, :W],
            consts["band_period"][:, :W], it,
        )
        return grad, dict(carry, active_edges=torch.sum(c, dim=1, keepdim=True))

    def _attractive_gradients(self, Z, consts, carry, it):
        if consts["edge_schedule"] == "bands":
            return self._attractive_gradients_bands(Z, consts, carry, it)
        G = consts["edge_groups_G"]
        if G > 1:
            g = it % G
            NN, eps = consts["NN"][g], consts["epochs_per_sample"][g]
        else:
            NN, eps = consts["NN"], consts["epochs_per_sample"]
        grad, c = self._attr_core(Z, NN, eps, float(G), it)
        return grad, dict(carry, active_edges=c)

    def _repulsive_gradients(self, Z, consts, carry, it, neg_ids=None):
        # negatives due this step: negative_sample_rate per fired edge
        neg_counts = torch.sum(carry["active_edges"], dim=1) * self.negative_sample_rate
        n = consts["n"]

        if self.shared_negatives:
            S = self._shared_negative_count(int(n)) if neg_ids is None else neg_ids.shape[0]
            if neg_ids is None:
                neg_ids = self._draw_shared_negatives(n, S, Z.device)
            if Z.shape[1] <= MAX_D:
                # K1: every point repels against one shared sample of S
                # points, each weighted by neg_counts_i / S
                w = neg_counts.float() / S
                return fused_shared_repulsion(Z, neg_ids, w, self._a, self._b, self._eps), carry
            # Embedding wider than K1 takes: the reference's gram form,
            # D = ‖z_i‖² + ‖z_s‖² − 2 Z Zₛᵀ, grad = (Σ_s c) z_i − c Zₛ.
            D, valid, Zneg = self._shared_negative_sqdists(Z, consts, neg_ids)
            coef = _div(-2.0 * self._b, (D + self._eps) * (1.0 + self._a * D**self._b))
            coef = torch.where(valid, coef, torch.zeros_like(coef))
            coef = coef * (neg_counts.float() / S)[:, None]
            grad = torch.clamp(
                torch.sum(coef, dim=1)[:, None] * Z - coef @ Zneg, -4.0, 4.0
            )
            return grad, carry

        neg = self._sample_negatives(consts)
        diff = Z[:, None, :] - Z[neg]
        D = torch.sum(diff * diff, dim=-1)
        coef = _div(-2.0 * self._b, (D + self._eps) * (1.0 + self._a * D**self._b))
        # keep negative_sample_rate negative edges per active positive edge
        col = torch.arange(self.n_negatives, device=Z.device)
        coef = torch.where(col[None, :] >= neg_counts[:, None], torch.zeros_like(coef), coef)
        grad = torch.clamp(torch.sum(diff * coef[:, :, None], dim=1), -4.0, 4.0)
        return grad, carry

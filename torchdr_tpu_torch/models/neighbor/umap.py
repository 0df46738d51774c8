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

On a device mesh of more than one shard the step is row-sharded (where
the repulsion is K1: shared negatives, width up to 8). Each shard's rows
of the edge arrays are placed on its device once a fit; each step copies
Z and the step's one draw of negatives to every device, computes on each
shard its rows' attraction and fire counts (gathering from its copy of Z)
and K1 over its rows against the shared sample, and gathers the gradient
and the fire counts on the mesh's first device, which keeps Z and the
optimizer's state. No row's sum is split across devices, so the result is
the one-device step's.

On CUDA devices one thread issues every shard, so a shard's ~30 operators
would cost the host four times the one-card step's issue (threads, one a
card, were slower still: they contend for the GIL at every operator);
each shard's step is instead replayed from a CUDA graph
(:class:`_ShardGraphs`), captured from the same operators with the step
counter and the edge group as inputs on the device, so a replay gives the
eager step's bits: one graph a shard (and, under the bands schedule, a
prefix width). A fit's first step runs eagerly, which loads every kernel
on every device before any capture.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Union

import numpy as np
import torch

from ...affinity.knn_normalized import UMAPAffinity
from ...ops.cuda.umap_kernel import MAX_D, fused_shared_repulsion
from ...parallel.mesh import chunk_bounds
from .base import NeighborEmbedding, NegativeSamplingNeighborEmbedding


def _div(x, t: torch.Tensor) -> torch.Tensor:
    """x / t rounded as one IEEE division (torch's ``float / Tensor`` is
    ``t.reciprocal() * x``, which rounds twice); x a float or a 0-dim
    tensor on t's device."""
    return torch.div(x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=t.dtype), t)


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

    Over a device mesh (``mesh=``, or ``distributed=True``: every visible
    card) the kNN, the fuzzy union's edge exchange and each step are
    row-sharded: every device computes its rows' attraction and K1
    repulsion against the step's shared negatives, while Z, the optimizer's
    state and the affinity stay on the mesh's first device, which gathers
    the gradient. The result is the one-device step's.
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

    def _edge_consts(self, X):
        """The loop's constants on one device: the edge arrays of the
        fit's schedule."""
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

    def _build_consts(self, X):
        consts = self._edge_consts(X)
        mesh = getattr(self, "_fit_mesh_", None)
        if mesh is not None and len(mesh) > 1 and self.shared_negatives \
                and self.n_components <= MAX_D:
            consts["shards"] = self._shard_consts(consts, mesh)
            if all(d.type == "cuda" for d in mesh.devices):
                consts["graphs"] = _ShardGraphs(consts["shards"])
        return consts

    def _shard_consts(self, consts, mesh):
        """Each shard's rows (``chunk_bounds``) of the edge arrays, on its
        device, with what a step of them reads besides."""
        n, world = consts["n"], len(mesh)
        grouped = consts["edge_groups_G"] > 1  # (G, n, W) arrays
        shards = []
        for r, dev in enumerate(mesh.devices):
            row0, rows = chunk_bounds(n, world, r)
            part = slice(row0, row0 + rows)

            def cut(a):
                return (a[:, part] if grouped else a[part]).contiguous().to(dev)

            shard = {k: consts[k] for k in ("n", "edge_schedule", "edge_groups_G")}
            shard.update(device=dev, row0=row0, rows=rows, NN=cut(consts["NN"]),
                         epochs_per_sample=cut(consts["epochs_per_sample"]))
            if consts["edge_schedule"] == "bands":
                shard["band_widths"] = consts["band_widths"]
                shard["band_period"] = consts["band_period"].to(dev)
            shards.append(shard)
        return shards

    def _init_carry(self, consts):
        carry = super()._init_carry(consts)
        # attraction computes per-edge fire counts; repulsion consumes them
        P = consts["P"]
        carry["active_edges"] = torch.zeros(
            (consts["n"], consts["edge_group_width"]), dtype=torch.float32, device=P.device
        )
        return carry

    # --- closed-form gradients ---

    def _gradients(self, Z, consts, carry, it, ee_coeff, neg_ids=None):
        if "shards" not in consts:
            return super()._gradients(Z, consts, carry, it, ee_coeff, neg_ids)
        return self._sharded_gradients(Z, consts, carry, it, ee_coeff, neg_ids)

    def _sharded_gradients(self, Z, consts, carry, it, ee_coeff, neg_ids=None):
        """The step over the mesh's shards (module docstring): the full
        (n, d) gradient and (n, W) fire counts on Z's device."""
        n, shards = consts["n"], consts["shards"]
        if neg_ids is None:
            neg_ids = self._draw_shared_negatives(n, self._shared_negative_count(int(n)), Z.device)
        graphs = consts.get("graphs")
        if graphs is not None and graphs.warm:
            parts = graphs.step(self, Z, neg_ids, it, ee_coeff)
        else:  # a CPU mesh, or a CUDA mesh's first step
            copies = {dev: (Z.to(dev), neg_ids.to(dev))
                      for dev in dict.fromkeys(s["device"] for s in shards)}
            parts = [self._shard_step(*copies[s["device"]], s, it, ee_coeff) for s in shards]
            if graphs is not None:
                graphs.warm = True
        grad = torch.empty_like(Z)
        fired = torch.empty((n, parts[0][1].shape[1]), dtype=torch.float32, device=Z.device)
        for shard, (g, c) in zip(shards, parts):
            rows = slice(shard["row0"], shard["row0"] + shard["rows"])
            grad[rows].copy_(g)
            fired[rows].copy_(c)
        return grad, dict(carry, active_edges=fired)

    def _shard_step(self, Z, neg_ids, shard, it, ee_coeff):
        """One shard's (gradient, fire counts) at step ``it``: Z and the
        shared negatives on the shard's device, ``shard`` its rows' edge
        arrays (and, in a captured graph, the step counter ``now``)."""
        g, carry = NeighborEmbedding._gradients(self, Z, shard, {}, it, ee_coeff, neg_ids)
        return g, carry["active_edges"]

    def _step_variant(self, consts, it: int):
        """What a step's shapes depend on: the band prefix's width, under the
        bands schedule (the edge group is an input of the step)."""
        return self._band_width(consts, it) if consts["edge_schedule"] == "bands" else 0

    def _attr_core(self, Z, NN, eps, period, it: int, row0: int = 0, now=None):
        """Closed-form attraction over one (rows, W) edge slice: rows
        ``[row0, row0 + rows)`` of Z (all of them on one device), each
        edge's end gathered from all of Z.

        Returns (grad, per-edge fire counts c). The catch-up burst at step
        ``it`` is the number of fire events k·eps in (now−period, now]:
        floor(now/eps) − floor(max(now−period, 0)/eps), now = it + 1 (or
        ``now``, a 0-dim float32 tensor holding it: a captured graph's
        input). ``period`` is the slice's visit period: a float, or a (1, W)
        tensor of per-column periods (the bands schedule). Dead/pad edges
        carry eps=inf, so now/inf = 0 gives c = 0 with no masking.
        """
        Zi = Z if NN.shape[0] == Z.shape[0] else Z[row0 : row0 + NN.shape[0]]
        diff = Zi[:, None, :] - Z[NN]
        D = torch.sum(diff * diff, dim=-1)
        t = D**self._b
        coef = 2.0 * self._a * self._b * t / (torch.clamp(D, min=1e-20) * (1.0 + self._a * t))
        coef = torch.where(D > 0, coef, torch.zeros_like(coef))

        now = float(it + 1) if now is None else now
        if isinstance(period, torch.Tensor):
            prev = torch.clamp(now - period, min=0.0)
            c = torch.floor(_div(now, eps)) - torch.floor(prev / eps)
        else:
            # every value an integer, exact in float32 on either side
            prev = max(now - period, 0.0) if isinstance(now, float) else torch.clamp(
                now - period, min=0.0)
            c = torch.floor(_div(now, eps)) - torch.floor(_div(prev, eps))
        coef = coef * c
        grad = torch.clamp(torch.sum(diff * coef[:, :, None], dim=1), -4.0, 4.0)
        return grad, c

    @staticmethod
    def _band_width(consts, it: int) -> int:
        """The bands schedule's prefix width at step ``it``."""
        widths = consts["band_widths"]
        tz = (it & -it).bit_length() - 1 if it > 0 else len(widths) - 1
        return widths[min(tz, len(widths) - 1)]

    def _attractive_gradients_bands(self, Z, consts, carry, it):
        """Step ``it`` visits the row prefix of width
        band_widths[trailing_zeros(it)] (step 0 the last band's): every band
        b with it % 2^b == 0. A column is visited on a fixed period, its
        first band's, so _attr_core's burst count applies."""
        W = self._band_width(consts, it)
        grad, c = self._attr_core(
            Z, consts["NN"][:, :W], consts["epochs_per_sample"][:, :W],
            consts["band_period"][:, :W], it, consts.get("row0", 0), consts.get("now"),
        )
        return grad, dict(carry, active_edges=torch.sum(c, dim=1, keepdim=True))

    def _attractive_gradients(self, Z, consts, carry, it):
        if consts["edge_schedule"] == "bands":
            return self._attractive_gradients_bands(Z, consts, carry, it)
        G = consts["edge_groups_G"]
        if G > 1 and "group" in consts:  # the group an input on the device
            NN, eps = (torch.index_select(consts[k], 0, consts["group"])[0]
                       for k in ("NN", "epochs_per_sample"))
        elif G > 1:
            g = it % G
            NN, eps = consts["NN"][g], consts["epochs_per_sample"][g]
        else:
            NN, eps = consts["NN"], consts["epochs_per_sample"]
        grad, c = self._attr_core(Z, NN, eps, float(G), it, consts.get("row0", 0),
                                  consts.get("now"))
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
                # a shard's rows of Z, on a mesh
                rows = {"row0": consts["row0"], "rows": w.shape[0]} if "row0" in consts else {}
                return fused_shared_repulsion(Z, neg_ids, w, self._a, self._b, self._eps,
                                              **rows), carry
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


class _ShardGraphs:
    """The row-sharded step's shards replayed from CUDA graphs, from a fit's
    second step on (``warm``: the first runs eagerly).

    Each device holds the graphs' static inputs, allocated at the first
    replayed step: a copy of Z, the step's shared negatives, the step
    counter ``now`` (0-dim float32) and the edge group (a 1-element int64
    index). Each step copies Z and the draw into them and sets the counter
    and the group (a few operators a device), then replays each shard's
    graph of the step's variant (``UMAP._step_variant``), captured at that
    variant's first step from ``UMAP._shard_step`` itself; the outputs,
    static too, are copied to the first device by the caller before the
    next replay. A device's graphs share one memory pool, since they replay
    one after another on its stream. K1's launches inside a replay are
    counted as the eager step counts them.
    """

    def __init__(self, shards):
        self.shards = shards
        self.devices = list(dict.fromkeys(s["device"] for s in shards))
        self.inputs = {}  # device -> (Z, neg_ids, now, group)
        self.graphs = {}  # (shard, variant, ee_coeff) -> (graph, outputs, K1 launches)
        self.pools = {}  # device -> its graphs' memory pool
        self.warm = False

    def step(self, model, Z, neg_ids, it, ee_coeff):
        """Each shard's (gradient, fire counts) at step ``it``."""
        if not self.inputs:  # Z's and the draw's shapes are fixed for the fit
            self.inputs = {dev: (torch.empty_like(Z, device=dev),
                                 torch.empty_like(neg_ids, device=dev),
                                 torch.zeros((), dtype=torch.float32, device=dev),
                                 torch.zeros(1, dtype=torch.int64, device=dev))
                           for dev in self.devices}
        G = self.shards[0]["edge_groups_G"]
        for Zs, neg, now, group in self.inputs.values():
            Zs.copy_(Z)
            neg.copy_(neg_ids)
            now.fill_(it + 1)
            if G > 1:
                group.fill_(it % G)
        out = []
        for r, shard in enumerate(self.shards):
            key = (r, model._step_variant(shard, it), float(ee_coeff))
            if key not in self.graphs:
                self.graphs[key] = self._capture(model, shard, it, ee_coeff)
            graph, outputs, k1 = self.graphs[key]
            with torch.cuda.device(shard["device"]):
                graph.replay()
            fused_shared_repulsion.launches += k1
            out.append(outputs)
        return out

    def _capture(self, model, shard, it, ee_coeff):
        device = shard["device"]
        Zs, neg, now, group = self.inputs[device]
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        graph = torch.cuda.CUDAGraph()
        launches = fused_shared_repulsion.launches
        with torch.cuda.device(device), torch.cuda.stream(stream):
            graph.capture_begin(pool=self.pools.get(device))
            try:
                outputs = model._shard_step(Zs, neg, dict(shard, now=now, group=group), it,
                                            ee_coeff)
            finally:
                graph.capture_end()
        # a capture launches nothing: its K1 calls count at each replay
        k1, fused_shared_repulsion.launches = fused_shared_repulsion.launches - launches, launches
        self.pools.setdefault(device, graph.pool())
        torch.cuda.current_stream(device).wait_stream(stream)
        return graph, outputs, k1

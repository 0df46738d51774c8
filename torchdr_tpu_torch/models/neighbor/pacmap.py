"""PACMAP (counterpart of ``torchdr_tpu/models/neighbor/pacmap.py``).

Three loss terms (near, mid-near, far pairs) with the three-phase weight
schedule as functions of the step counter. Mid-near pairs are drawn anew
every ``mn_resample_every`` steps while their weight is positive (phases
1-2): 6 candidates per slot, the 2nd closest in input space kept. The JAX
package gates that draw with ``lax.cond``; here it is a Python ``if`` on
the step number, with the same trajectory. The far pairs are per-point
negatives. Gradients come by autograd of the loss.

Each draw is an optional argument: ``cand`` (the (n_mid_near, n, 6)
candidate ids) and ``u`` (the per-point uniform draw of the far pairs).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ...affinity.knn_normalized import PACMAPAffinity
from ...ops.distance import pairwise_distances_indexed
from .base import NegativeSamplingNeighborEmbedding


class PACMAP(NegativeSamplingNeighborEmbedding):
    """PACMAP (Wang et al. 2021)."""

    def __init__(
        self,
        n_neighbors: int = 10,
        n_components: int = 2,
        lr: float = 1e0,
        optimizer: str = "Adam",
        optimizer_kwargs: Union[Dict, str, None] = None,
        scheduler: Optional[str] = None,
        scheduler_kwargs: Optional[Dict] = None,
        init: str = "pca",
        init_scaling: float = 1e-4,
        min_grad_norm: float = 1e-7,
        max_iter: int = 450,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        metric: str = "sqeuclidean",
        MN_ratio: float = 0.5,
        FP_ratio: float = 2.0,
        iter_per_phase: int = 100,
        check_interval: int = 50,
        discard_NNs: bool = False,
        knn_mode="exact",
        mn_resample_every: int = 1,
        **kwargs,
    ):
        self.n_neighbors = n_neighbors
        self.metric = metric
        self.knn_mode = knn_mode
        #: refresh the mid-near pair set every R steps (1 = every step)
        self.mn_resample_every = int(mn_resample_every)
        if self.mn_resample_every < 1:
            raise ValueError("[TorchDR-Torch] ERROR : mn_resample_every must be >= 1.")
        self.MN_ratio = MN_ratio
        self.FP_ratio = FP_ratio
        self.n_mid_near = max(int(MN_ratio * n_neighbors), 1)
        self.n_further = max(int(FP_ratio * n_neighbors), 1)
        self.iter_per_phase = iter_per_phase

        affinity_in = PACMAPAffinity(
            n_neighbors=n_neighbors,
            metric=metric,
            device=device,
            verbose=verbose,
            knn_mode=knn_mode,
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
            n_negatives=self.n_further,
            discard_NNs=discard_NNs,
            **kwargs,
        )

    def _weights(self, it: int):
        """(w_NB, w_MN, w_FP) at step ``it``, in float32 as the JAX package
        forms them."""
        T = self.iter_per_phase
        f32 = np.float32
        if it < T:
            itf = f32(it)
            w_MN = f32(1000.0) * (f32(1.0) - itf / f32(T)) + f32(3.0) * itf / f32(T)
            return 2.0, float(w_MN), 1.0
        if it < 2 * T:
            return 3.0, 3.0, 1.0
        return 1.0, 0.0, 1.0

    def _build_consts(self, X):
        consts = super()._build_consts(X)
        consts.pop("P", None)  # PACMAP uses indices only
        consts["X"] = X  # kept for mid-near input-space distances
        return consts

    def _init_carry(self, consts):
        carry = super()._init_carry(consts)
        if self.mn_resample_every > 1:
            # refreshed at it = 0 (0 % R == 0) before first use
            carry["mid_near"] = torch.zeros(
                (consts["n"], self.n_mid_near), dtype=torch.int32, device=consts["X"].device
            )
        return carry

    def _draw_mid_near(self, X, n, cand=None):
        """Mid-near pairs (n, n_mid_near) int32: for each slot, 6 candidates
        per row uniform over the other rows, the 2nd closest in input space
        kept. ``cand`` is the (n_mid_near, n, 6) uniform draw in [0, n - 1),
        before the shift past each row itself; drawn from the fit's
        generator when not given. One slot at a time: each gathers an
        (n, 6, d) block of X."""
        if cand is None:
            cand = torch.randint(
                0, n - 1, (self.n_mid_near, n, 6), generator=self._generator_, device=X.device
            )
        cand = cand.long()
        self_idx = torch.arange(n, device=X.device)[None, :, None]
        cand = cand + (cand >= self_idx).long()
        slots = []
        for c in cand:
            D = pairwise_distances_indexed(X, key_indices=c, metric=self.metric)
            # the 2nd smallest, equal values by index as lax.top_k orders them
            second = torch.sort(D, dim=1, stable=True).indices[:, 1:2]
            slots.append(torch.gather(c, 1, second)[:, 0])
        return torch.stack(slots, dim=1).to(torch.int32)

    def _attractive_loss(self, Z, consts, carry, it, cand=None):
        w_NB, w_MN, _ = self._weights(it)
        Q_near = 1.0 + pairwise_distances_indexed(Z, key_indices=consts["NN"], metric="sqeuclidean")
        near_loss = w_NB * torch.sum(Q_near / (10.0 + Q_near))

        # The candidate draw and its input-space distances run only on the
        # steps that use them: never in phase 3, where w_MN = 0 zeroes the
        # term, and with R > 1 only on refresh steps (it % R == 0).
        X, n = consts["X"], consts["n"]
        active = w_MN > 0
        R = self.mn_resample_every
        if R == 1:
            mid_near = self._draw_mid_near(X, n, cand) if active else None
        else:
            if active and it % R == 0:
                carry = dict(carry, mid_near=self._draw_mid_near(X, n, cand))
            mid_near = carry["mid_near"]
        if not active:
            return near_loss, carry
        Q_mid = 1.0 + pairwise_distances_indexed(Z, key_indices=mid_near, metric="sqeuclidean")
        return near_loss + w_MN * torch.sum(Q_mid / (1e4 + Q_mid)), carry

    def _repulsive_loss(self, Z, consts, carry, it, u=None):
        _, _, w_FP = self._weights(it)
        neg = self._sample_negatives(consts, u=u)
        Q_far = 1.0 + pairwise_distances_indexed(Z, key_indices=neg, metric="sqeuclidean")
        return w_FP * torch.sum(1.0 / (1.0 + Q_far)), carry

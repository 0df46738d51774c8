"""Base classes for neighbor embedding methods.

Counterpart of ``torchdr_tpu/models/neighbor/base.py``: the loss splits
into attraction and repulsion, and negatives are drawn each step. Every
function that draws takes the draw as an optional argument (``neg_ids`` or
``u``), so a test can hand in the same numbers the JAX package drew.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ...affinity.base import Affinity
from ...affinity_matcher import AffinityMatcher
from ...ops.metrics import sq_dists_from_gram


class NeighborEmbedding(AffinityMatcher):
    r"""Attraction/repulsion neighbor-embedding base.

    loss = ee_coeff(it) · attractive + repulsion_strength · repulsive (the
    autograd path), or the same combination of closed-form gradients.
    """

    def __init__(
        self,
        affinity_in: Union[Affinity, str],
        affinity_out: Optional[Affinity] = None,
        kwargs_affinity_out: Optional[Dict] = None,
        n_components: int = 2,
        lr: Union[float, str] = 1e0,
        optimizer: str = "SGD",
        optimizer_kwargs: Union[Dict, str, None] = "auto",
        scheduler: Optional[str] = None,
        scheduler_kwargs: Union[Dict, str, None] = "auto",
        min_grad_norm: float = 1e-7,
        max_iter: int = 2000,
        init: Union[str, np.ndarray] = "pca",
        init_scaling: float = 1e-4,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        early_exaggeration_coeff: Optional[float] = None,
        early_exaggeration_iter: Optional[int] = None,
        repulsion_strength: float = 1.0,
        check_interval: int = 50,
        **kwargs,
    ):
        super().__init__(
            affinity_in=affinity_in,
            affinity_out=affinity_out,
            kwargs_affinity_out=kwargs_affinity_out,
            n_components=n_components,
            optimizer=optimizer,
            optimizer_kwargs=optimizer_kwargs,
            lr=lr,
            scheduler=scheduler,
            scheduler_kwargs=scheduler_kwargs,
            min_grad_norm=min_grad_norm,
            max_iter=max_iter,
            init=init,
            init_scaling=init_scaling,
            device=device,
            verbose=verbose,
            random_state=random_state,
            check_interval=check_interval,
            **kwargs,
        )
        self.early_exaggeration_coeff = early_exaggeration_coeff
        self.early_exaggeration_iter = early_exaggeration_iter
        self.repulsion_strength = repulsion_strength
        self._ee_coeff = float(early_exaggeration_coeff or 1.0)
        self._ee_iter = int(early_exaggeration_iter or 0)

    def _check_n_neighbors(self, n: int):
        for param_name in ("perplexity", "n_neighbors"):
            value = getattr(self, param_name, None)
            if value is not None and n <= value:
                raise ValueError(
                    f"[TorchDR-Torch] ERROR : Number of samples is smaller than "
                    f"{param_name} ({n} <= {value})."
                )
        return self

    def _fit_transform(self, X: torch.Tensor, y=None) -> torch.Tensor:
        self._check_n_neighbors(X.shape[0])
        return super()._fit_transform(X, y)

    def _loss(self, Z, consts, carry, it, ee_coeff):
        attr, carry = self._attractive_loss(Z, consts, carry, it)
        rep, carry = self._repulsive_loss(Z, consts, carry, it)
        return ee_coeff * attr + self.repulsion_strength * rep, carry

    def _attractive_loss(self, Z, consts, carry, it):
        raise NotImplementedError

    def _repulsive_loss(self, Z, consts, carry, it):
        raise NotImplementedError

    def _gradients(self, Z, consts, carry, it, ee_coeff, neg_ids=None):
        g_attr, carry = self._attractive_gradients(Z, consts, carry, it)
        g_rep, carry = self._repulsive_gradients(Z, consts, carry, it, neg_ids=neg_ids)
        return ee_coeff * g_attr + self.repulsion_strength * g_rep, carry

    def _attractive_gradients(self, Z, consts, carry, it):
        raise NotImplementedError

    def _repulsive_gradients(self, Z, consts, carry, it, neg_ids=None):
        raise NotImplementedError


class NegativeSamplingNeighborEmbedding(NeighborEmbedding):
    r"""Neighbor embedding with O(n) repulsion via per-step negative sampling.

    Either one shared uniform sample of S points per step (the default), or
    ``n_negatives`` uniform draws per row that skip excluded columns (self,
    and the NNs with ``discard_NNs``) by the sorted-exclusion shift.
    """

    def __init__(
        self,
        affinity_in: Union[Affinity, str],
        n_negatives: int = 5,
        discard_NNs: bool = False,
        shared_negatives: bool = True,
        n_shared_negatives: int | None = None,
        **kwargs,
    ):
        super().__init__(affinity_in=affinity_in, **kwargs)
        self.n_negatives = n_negatives
        self.discard_NNs = discard_NNs
        self.shared_negatives = shared_negatives
        self.n_shared_negatives = n_shared_negatives

    def on_affinity_computation_end(self):
        super().on_affinity_computation_end()
        n = self.n_samples_in_
        device = self.device_
        self_idx = torch.arange(n, device=device)[:, None]
        if self.discard_NNs and self.NN_indices_ is not None:
            # -1 pads become distinct out-of-range sentinels: they sort last
            # and never shift a draw
            nn = self.NN_indices_.long()
            sentinel = n + torch.arange(nn.shape[1], device=device)[None, :]
            nn = torch.where(nn >= 0, nn, sentinel)
            exclude = torch.cat([self_idx, nn], dim=1)
        else:
            if self.discard_NNs:
                self.logger.warning(
                    "NN_indices_ not found. Cannot discard NNs from negative sampling."
                )
            exclude = self_idx
        self.neg_exclusion_ = torch.sort(exclude, dim=1).values
        self.neg_valid_counts_ = torch.sum(self.neg_exclusion_ < n, dim=1)

        n_possible = n - int(torch.max(self.neg_valid_counts_))
        if self.n_negatives > n_possible:
            raise ValueError(
                f"[TorchDR-Torch] ERROR : requested {self.n_negatives} negatives but "
                f"only {n_possible} available."
            )

    def _build_consts(self, X):
        consts = super()._build_consts(X)
        consts["neg_exclusion"] = self.neg_exclusion_
        consts["neg_valid_counts"] = self.neg_valid_counts_
        return consts

    def _shared_negative_count(self, n: int) -> int:
        if self.n_shared_negatives is not None:
            return int(self.n_shared_negatives)
        return 2048 if n <= 300_000 else (1024 if n <= 1_000_000 else 512)

    def _draw_shared_negatives(self, n: int, S: int, device) -> torch.Tensor:
        """One uniform sample of S ids in [0, n), from the fit's generator."""
        return torch.randint(0, n, (S,), generator=self._generator_, device=device)

    def _shared_negative_sqdists(self, Z, consts, neg_ids=None):
        """(D, valid, Zneg) for one shared uniform negative sample.

        D is the (n, S) squared-euclidean block (exact float32 gram);
        ``valid`` masks self-collisions.
        """
        n = consts["n"]
        if neg_ids is None:
            neg_ids = self._draw_shared_negatives(n, self._shared_negative_count(n), Z.device)
        Zneg = Z[neg_ids]
        D = sq_dists_from_gram(
            torch.sum(Z * Z, dim=-1), torch.sum(Zneg * Zneg, dim=-1), Z @ Zneg.T
        )
        valid = neg_ids[None, :] != torch.arange(Z.shape[0], device=Z.device)[:, None]
        return D, valid, Zneg

    def _sample_negatives(self, consts, u=None) -> torch.Tensor:
        """Draw (n, n_negatives) indices uniform over non-excluded columns.

        ``u`` is the (n, n_negatives) uniform draw in [0, 1); drawn from the
        fit's generator when not given.
        """
        exclusion = consts["neg_exclusion"]
        counts = consts["neg_valid_counts"]
        n = consts["n"]
        if u is None:
            u = torch.rand(
                (exclusion.shape[0], self.n_negatives), generator=self._generator_,
                device=exclusion.device,
            )
        draws = torch.floor(u * (n - counts)[:, None]).long()
        if exclusion.shape[1] == 1:
            return draws + (draws >= exclusion).long()
        return draws + torch.searchsorted(exclusion.contiguous(), draws, right=True)

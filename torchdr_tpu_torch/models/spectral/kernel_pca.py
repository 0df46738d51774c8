"""Kernel PCA (counterpart of ``torchdr_tpu/models/spectral/kernel_pca.py``).

Three solvers, as in the JAX package:

- ``solver="eigh"``: the dense kernel, double-centred, and one
  ``torch.linalg.eigh``;
- ``solver="lobpcg"`` with a Gaussian or Student kernel on (squared)
  Euclidean distances, unnormalized or normalized over the whole matrix:
  LOBPCG (:func:`~torchdr_tpu_torch.utils.lobpcg.lobpcg_standard`) on a
  matrix-free operator V ↦ HKHV + shift·V that recomputes the kernel's
  (block, n) row blocks from X in every product and never forms K
  (O(block · n) live memory); H = I − 11ᵀ/n is applied by subtracting
  column means on both sides. A global normalization is one scalar Z:
  the eigenvectors are unchanged and the eigenvalues scale by 1/Z;
- ``solver="lobpcg"`` with any other affinity: LOBPCG on the dense kernel,
  centred inside the product.

``lobpcg_iterations_`` holds the LOBPCG iteration count of the last fit
(None for "eigh"). The LOBPCG start is a normal draw from the estimator's
generator; the ``X0`` argument of :meth:`KernelPCA._lobpcg_matfree` and
:meth:`KernelPCA._lobpcg_dense` takes a given draw instead. With a device
mesh (``mesh=``) the matrix-free operator is row-sharded over it, as the
JAX package's ``shard_map`` tier: each shard's device forms and multiplies
the kernel rows of its chunk, and the product's rows are gathered on the
fit's device.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ...affinity.base import Affinity
from ...affinity.entropic import NormalizedGaussianAffinity, NormalizedStudentAffinity
from ...base import DRModule
from ...ops.metrics import pairwise_block
from ...ops.reductions import center_kernel, check_nonnegativity_eigenvalues, svd_flip
from ...parallel.mesh import check_mesh, replicate
from ...utils.lobpcg import lobpcg_standard

# diagonal shift of the matrix-free operator: the centred kernel is positive
# semi-definite, LOBPCG wants it definite
_SHIFT = 1e-3


class KernelPCA(DRModule):
    """Kernel Principal Component Analysis.

    Parameters
    ----------
    affinity : Affinity, default NormalizedGaussianAffinity(normalization_dim=None)
        Affinity producing the kernel matrix (on the estimator's device
        when it is the default).
    n_components : int, default=2
    nodiag : bool, default=False
        Drop zero-eigenvalue components.
    solver : {"eigh", "lobpcg"}, default="eigh"
        "lobpcg" avoids the full O(n³) eigendecomposition for large n.
    tol : float, optional
        LOBPCG stop: every pair's residual |HKHv − θv| below
        tol · (|HKHv| + θ). None keeps the JAX package's rule, which is
        tol = 10 · n · ε(float32): 0.0715 at n = 60,000, loose enough to stop
        near-degenerate top pairs far from convergence (ROADMAP, "Quirks of
        the reference").
    mesh : Mesh, optional
        Row-shards the matrix-free LOBPCG operator over a device mesh: each
        device forms and multiplies the kernel rows of its chunk. The fit
        keeps its state on the mesh's first device.
    """

    def __init__(
        self,
        affinity: Optional[Affinity] = None,
        n_components: int = 2,
        device: str = "auto",
        verbose: bool = False,
        random_state: Optional[int] = None,
        nodiag: bool = False,
        solver: str = "eigh",
        mesh=None,
        tol: Optional[float] = None,
        **kwargs,
    ):
        super().__init__(
            n_components=n_components,
            device=device,
            verbose=verbose,
            random_state=random_state,
            process_duplicates=False,
            **kwargs,
        )
        self.affinity = affinity if affinity is not None else NormalizedGaussianAffinity(
            normalization_dim=None, device=device
        )
        self.nodiag = nodiag
        self.solver = solver
        self.mesh = check_mesh(mesh)
        self.tol = tol

    def _fit_transform(self, X: torch.Tensor, y: Optional[Any] = None) -> torch.Tensor:
        self.lobpcg_iterations_ = None
        if self.solver == "lobpcg":
            kern = self._kernel_block_fn()
            if kern is not None:
                # matrix-free: K is never formed
                eigvals, eigvecs = self._lobpcg_matfree(X, kern)
            else:
                # dense K, centred inside the product
                eigvals, eigvecs = self._lobpcg_dense(self.affinity(X))
        else:
            K = center_kernel(self.affinity(X))
            eigvals, eigvecs = torch.linalg.eigh(K)
            eigvals = torch.flip(eigvals, (0,))
            eigvecs = torch.flip(eigvecs, (1,))

        eigvals = check_nonnegativity_eigenvalues(eigvals)
        eigvecs, _ = svd_flip(eigvecs, torch.zeros_like(eigvecs).T)

        if self.nodiag or self.n_components is None:
            # keep the strictly positive directions (sorted descending)
            keep = int(torch.sum(eigvals > 0))
            eigvecs = eigvecs[:, :keep]
            eigvals = eigvals[:keep]

        eigvecs = eigvecs[:, : self.n_components]
        self.eigenvectors_ = eigvecs
        self.eigenvalues_ = eigvals
        return eigvecs * torch.sqrt(torch.clamp(eigvals[: self.n_components], min=0.0))

    # --- LOBPCG tier ---

    def _lobpcg_k(self, n: int) -> int:
        return min(self.n_components + (0 if not self.nodiag else 2), n // 2 or 1)

    def _lobpcg(self, matvec, X0: torch.Tensor):
        n = X0.shape[0]
        tol = None if self.tol is None else self.tol / (10 * n)
        theta, U, self.lobpcg_iterations_ = lobpcg_standard(matvec, X0, m=200, tol=tol)
        order = torch.argsort(-theta)
        return theta[order], U[:, order]

    def _start(self, n: int, X0: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
        if X0 is not None:
            return torch.as_tensor(X0, dtype=like.dtype).to(like.device)
        return torch.randn((n, self._lobpcg_k(n)), generator=self._root_generator(),
                           dtype=like.dtype, device=like.device)

    def _kernel_block_fn(self) -> Optional[Callable]:
        """The elementwise kernel of distances for the matrix-free operator,
        or None when the affinity has no matrix-free form: a Gaussian or
        Student kernel on (squared) Euclidean distances, normalized over
        the whole matrix or not at all (row or column normalization breaks
        the symmetry and stays dense)."""
        aff = self.affinity
        if type(aff) is NormalizedStudentAffinity:
            nu = float(aff.degrees_of_freedom)

            def kern(C):
                return torch.exp(-0.5 * (nu + 1.0) * torch.log1p(C / nu))

        elif type(aff) is NormalizedGaussianAffinity:
            sigma = float(aff.sigma)

            def kern(C):
                return torch.exp(-C / sigma)

        else:
            return None
        if aff.normalization_dim not in (None, (0, 1)):
            return None
        if aff.metric not in ("sqeuclidean", "euclidean"):
            return None
        return kern

    def _matfree_operator(self, X: torch.Tensor, kern: Callable, block: int = 512):
        """``(matvec, row_sums)`` of the unnormalized kernel of X:
        ``matvec(W)`` = HKHW + shift·W for W (n, k), ``row_sums()`` = K1,
        each recomputing K's (block, n) row blocks from X once."""
        aff = self.affinity
        sqrt_metric = aff.metric == "euclidean"
        zero_diag = bool(aff.zero_diag)
        n = X.shape[0]
        X = X.to(torch.float32)
        # the conditioning of Affinity._distance_matrix: distances are
        # translation invariant, the norms-plus-gram form is not
        X = X - torch.mean(X, dim=0, keepdim=True)
        # (device, X there, row block starts): the whole operator, or one
        # row chunk per shard of the mesh, each on its device
        if self.mesh is None:
            parts = [(X.device, X, range(0, n, block))]
        else:
            world = len(self.mesh)
            chunk = -(-n // world)
            block = min(block, chunk)
            parts = [(Xd.device, Xd, range(r * chunk, min(n, (r + 1) * chunk), block))
                     for r, Xd in enumerate(replicate(X, self.mesh))]

        def rows(Xd: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
            C = pairwise_block(Xd[r0:r1], Xd, "sqeuclidean")
            if sqrt_metric:
                C = torch.sqrt(torch.clamp(C, min=0.0))
            Kb = kern(C)
            if zero_diag:
                Kb.diagonal(r0).zero_()
            return Kb

        def blocks(starts):
            stop = starts.stop
            return [(r0, min(stop, r0 + block)) for r0 in starts]

        def matvec(W):
            Wc = W - torch.mean(W, dim=0, keepdim=True)
            U = torch.cat([
                (rows(Xd, r0, r1) @ Wc.to(dev)).to(W.device)
                for dev, Xd, starts in parts for r0, r1 in blocks(starts)
            ])
            U = U - torch.mean(U, dim=0, keepdim=True)
            return U + _SHIFT * W

        def row_sums():
            return torch.cat([
                torch.sum(rows(Xd, r0, r1), dim=1).to(X.device)
                for dev, Xd, starts in parts for r0, r1 in blocks(starts)
            ])

        return matvec, row_sums

    def _lobpcg_matfree(self, X: torch.Tensor, kern: Callable, block: int = 512,
                        X0: Optional[torch.Tensor] = None):
        """Top-k eigenpairs of the centred kernel without forming it."""
        matvec, row_sums = self._matfree_operator(X, kern, block)
        # a global (0, 1) normalization divides K by Z = its sum
        Z = 1.0
        if self.affinity.normalization_dim == (0, 1):
            Z = float(torch.sum(row_sums()))
        theta, U = self._lobpcg(matvec, self._start(X.shape[0], X0, X))
        return (theta - _SHIFT) / Z, U

    def _lobpcg_dense(self, K: torch.Tensor, X0: Optional[torch.Tensor] = None):
        """LOBPCG on a dense kernel; the centring and a diagonal shift are
        applied inside the product, so no second (n, n) buffer is made."""
        n = K.shape[0]
        shift = 1e-6 * torch.trace(K) / n

        def matvec(W):
            Wc = W - torch.mean(W, dim=0, keepdim=True)
            U = K @ Wc
            return U - torch.mean(U, dim=0, keepdim=True) + shift * W

        theta, U = self._lobpcg(matvec, self._start(n, X0, K))
        return theta - shift, U

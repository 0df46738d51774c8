"""What a timed fit leaves for the check, and the comparisons that judge it.

A :class:`Watch` rides along every fit of a run, timed ones included, and
keeps the last fit's:

- the ids of the kNN graph that the affinity's kNN call returned, for the
  sampled rows (``knn_ids``; UMAP's ``NN_indices_`` holds the fuzzy union's
  ids by the end of the affinity phase, and its pruned graph after the fit),
  and the whole graph (``knn_graph``, held rather than copied: the fit holds
  it through its affinity phase anyway);
- the input affinity's rows for the sampled rows as the affinity phase ends
  (``p_ids``, ``p_vals``), before anything prunes them;
- the embedding before each of the last two steps (``steps``), the last
  step's gradient (``grad``) and whatever else that step took (``extra``);

all of it copies of a few rows, or of (n, d) and (n, W) arrays at two steps
of a fit's hundreds, so the timed path does the same work as without it.
The fit's own output, the host array ``fit_transform`` returns, is judged
as it is.

The watch rides on hooks of the program (each estimator's file names its
own in ``HOOKS``): where a change to the program stops calling one, the
check raises :class:`HookNotReached`, naming the hook, and the run comes
out not correct with that named on standard error.
"""

from __future__ import annotations

import torch


class HookNotReached(RuntimeError):
    """A hook of the program that the check rides on left nothing in the last fit."""


class Watch:
    def __init__(self, rows: torch.Tensor):
        self.rows = rows
        self.reset()

    def reset(self) -> None:
        self.knn_ids = None
        self.knn_graph = None
        self.p_ids = None
        self.p_vals = None
        self.steps = {}
        self.grad = None
        self.extra = {}

    def snapshot(self) -> "Watch":
        """What the last fit left, which later fits leave alone."""
        kept = Watch(self.rows)
        kept.__dict__.update(self.__dict__)
        kept.steps, kept.extra = dict(self.steps), dict(self.extra)
        return kept

    def need(self, hooks: dict, *names, steps=()) -> None:
        """Raise :class:`HookNotReached` unless the last fit filled each
        field of ``names`` and kept the embedding before each of ``steps``;
        ``hooks`` maps a field to the program's hook that fills it."""
        gone = [n for n in names if getattr(self, n) is None
                or (isinstance(getattr(self, n), dict) and not getattr(self, n))]
        if any(it not in self.steps for it in steps):
            gone.append("steps")
        if gone:
            raise HookNotReached("perfbench: hook not reached in the last fit: " + "; ".join(
                f"{n} (from {hooks[n]})" for n in gone))

    def wrap_knn(self, affinity) -> None:
        """Keep the sampled rows' ids of each kNN graph the affinity builds."""
        build = affinity._distance_matrix

        def watched(X, k=None, return_indices=False):
            out = build(X, k=k, return_indices=return_indices)
            if k is not None and return_indices:
                self.knn_ids = out[1][self.rows].clone()
                self.knn_graph = out[1]  # held, not copied
            return out

        affinity._distance_matrix = watched

    def keep_affinity(self, P: torch.Tensor, NN: torch.Tensor) -> None:
        self.p_vals = P[self.rows].clone()
        self.p_ids = NN[self.rows].clone()


def ulp32(x: torch.Tensor) -> torch.Tensor:
    """The spacing of float32 numbers at |x|."""
    e = torch.floor(torch.log2(x.abs().double().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 23)


def widest_row_gap(got: torch.Tensor, want: torch.Tensor, allow=None) -> float:
    """max over rows of |got - want| (widest coordinate), less ``allow`` per
    coordinate where given, as a share of that row's |want| or of the
    median row's, whichever is larger (some rows are all but zero)."""
    got, want = got.double(), want.double()
    gap = (got - want).abs()
    if allow is not None:
        gap = (gap - allow).clamp(min=0.0)
    size = want.abs().amax(1)
    scale = torch.maximum(size, size.median())
    return float((gap.amax(1) / scale.clamp(min=torch.finfo(torch.float64).tiny)).max())


def quantile(values: torch.Tensor, q: float) -> float:
    return float(torch.quantile(values.double(), q))

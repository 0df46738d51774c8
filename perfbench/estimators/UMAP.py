"""UMAP cells: how a fit is built and watched, and the numbers that judge it.

The numbers, each a gap that a sound run keeps small (the limits are in the
cell's file; ``PERF.md`` gives the readings they were set from):

- ``knn_miss``: 1 - recall@k of the kNN graph on the sampled rows against
  their exact neighbours (float64 differences);
- ``p_gap``: the 90th percentile over the sampled rows of the widest gap
  between the row of P that the affinity phase ended with and the
  reference's fuzzy union, as a share of the row's largest entry. The
  reference builds it on its own exact graph, or, where the configuration
  asks for an approximate (IVF) graph, on the program's graph, with its own
  float64 distances (``knn_miss`` judges that graph);
- ``eps_gap``: the 99th percentile over the last step's edges of the gap
  between the period between fires the step gave each edge and the one the
  reference's P gives it, as a share of the latter (an edge live on one
  side only counts 1);
- ``fire_miss``: the share of the last step's firing edges whose fire count
  is not the count that edge's period gives at that step;
- ``grad_gap``: the last step's gradient against the reference's at the
  same embedding, edges, fire counts and shared negatives (the program's
  state at that step, which the three numbers above check), widest row, as
  a share of the row's size or the median row's;
- ``step_gap``: the embedding ``fit_transform`` returned against the
  embedding before the last step moved by the reference's gradient, beyond
  one float32 spacing of the result, as a share of the step.
"""

from __future__ import annotations

import torch

from perfbench.reference import affinity as ref_aff
from perfbench.reference import gradient as ref_grad
from perfbench.reference.knn import all_neighbours, edge_distances, neighbours_of_rows
from perfbench.reference.precision import CONTROL, REFERENCE, tf32_off
from perfbench.reference.quality import recall
from perfbench.watch import quantile, ulp32, widest_row_gap

#: the CUDA sources a UMAP fit launches
KERNEL_SOURCES = ("umap_repulsion",)

#: the program's hooks the check rides on: what each field of the watch
#: comes from (a private hook that a change to the program stops calling
#: makes the check raise ``HookNotReached``, naming it)
HOOKS = {
    "knn_ids": "the input affinity's _distance_matrix(X, k, return_indices=True)",
    "knn_graph": "the input affinity's _distance_matrix(X, k, return_indices=True)",
    "p_ids": "on_affinity_computation_end (affinity_in_, NN_indices_)",
    "p_vals": "on_affinity_computation_end (affinity_in_, NN_indices_)",
    "steps": "UMAP._gradients(Z, consts, carry, it, ee_coeff, neg_ids) at each of the last two steps",
    "grad": "UMAP._gradients(Z, consts, carry, it, ee_coeff, neg_ids) at the last step",
    "extra": "UMAP._gradients at the last step: consts['NN'], ['epochs_per_sample'], "
             "['edge_groups_G'], ['edge_schedule'], carry['active_edges'], "
             "UMAP._draw_shared_negatives and UMAP._shared_negative_count",
}


def build(params: dict, random_state: int, device: str, watch):
    """The estimator, watched by ``watch`` (a :class:`perfbench.watch.Watch`)."""
    from torchdr_tpu_torch import UMAP

    class WatchedUMAP(UMAP):
        def on_affinity_computation_end(self):
            watch.keep_affinity(self.affinity_in_, self.NN_indices_)
            super().on_affinity_computation_end()

        def _gradients(self, Z, consts, carry, it, ee_coeff, neg_ids=None):
            last = int(self.max_iter) - 1
            if it < last - 1:
                return super()._gradients(Z, consts, carry, it, ee_coeff, neg_ids)
            watch.steps[it] = Z.detach().clone()
            if it < last:
                return super()._gradients(Z, consts, carry, it, ee_coeff, neg_ids)
            # the draw the step makes itself, made here so it can be kept
            n = consts["n"]
            neg = self._draw_shared_negatives(n, self._shared_negative_count(int(n)), Z.device)
            grad, carry = super()._gradients(Z, consts, carry, it, ee_coeff, neg)
            G = consts["edge_groups_G"]
            watch.grad = grad.clone()
            group = (lambda a: a[it % G]) if G > 1 else (lambda a: a)
            watch.extra = {"neg": neg.clone(), "fired": carry["active_edges"].clone(),
                           "nn": group(consts["NN"]).clone(),
                           "eps": group(consts["epochs_per_sample"]).clone(),
                           "G": G, "schedule": consts["edge_schedule"], "ee": ee_coeff}
            return grad, carry

    model = WatchedUMAP(random_state=random_state, device=device, **params)
    watch.wrap_knn(model.affinity_in)
    return model


def shapes(model, watch) -> dict:
    """The fit's shapes for K1's bound."""
    watch.need(HOOKS, "extra", steps=(int(model.max_iter) - 1,))
    n, d = watch.steps[max(watch.steps)].shape
    return {"n": n, "d": d, "S": int(watch.extra["neg"].shape[0])}


def _knn_mode(params: dict) -> str:
    mode = params.get("knn_mode", "exact")
    return mode["KnnConfig"].get("mode", "exact") if isinstance(mode, dict) else mode


def judge(params: dict, X, Z_out, watch, device, mode: str = REFERENCE) -> dict:
    """The numbers of the last fit (``mode=REFERENCE``), or those of the
    control put in the program's place (``mode=CONTROL``)."""
    with tf32_off():
        return _judge(params, X, Z_out, watch, device, mode)


def _judge(params, X, Z_out, watch, device, mode):
    k = int(params.get("n_neighbors", 30))
    max_iter = int(params.get("max_iter", 1000))
    k_out = max(8, -(-int(params.get("max_graph_degree") or 4 * k) // 8) * 8)
    approximate = _knn_mode(params) != "exact"
    watch.need(HOOKS, "knn_ids", "p_ids", "p_vals", "grad", "extra",
               *(("knn_graph",) if approximate else ()), steps=(max_iter - 1,))
    if watch.extra.get("schedule") not in ("groups", "exact"):
        raise ValueError(f"perfbench: edge schedule {watch.extra.get('schedule')!r} not judged")
    Xd = torch.as_tensor(X, device=device)
    n = Xd.shape[0]
    rows = watch.rows
    _, exact = neighbours_of_rows(Xd, rows, k)

    # an approximate graph is the program's own: the reference's affinity
    # follows it, and knn_miss judges it
    if approximate:
        ids = watch.knn_graph
        D = edge_distances(Xd, ids)
    else:
        D, ids = all_neighbours(Xd, k)
    ref_keys, ref_P = ref_aff.fuzzy_union(ref_aff.umap_memberships(D, k), ids, k_out)
    del D
    if mode == CONTROL:
        _, knn_ids = all_neighbours(Xd, k, CONTROL, rows=rows)
        if approximate:
            Dc, idc = edge_distances(Xd, ids, CONTROL), ids
        else:
            Dc, idc = all_neighbours(Xd, k, CONTROL)
        keys, vals = ref_aff.fuzzy_union(ref_aff.umap_memberships(Dc.float(), k), idc, k_out)
        got_P = ref_aff.rows_of(keys, vals, rows, n)
        del Dc, idc
    else:
        knn_ids = watch.knn_ids
        keys, vals = None, None
        got_P = ref_aff.padded_rows(n, rows, watch.p_ids, watch.p_vals)
    knn_recall = float(recall(knn_ids, exact).mean())
    p_gap = quantile(ref_aff.row_gaps(n, rows, got_P, ref_keys, ref_P), 0.9)

    # the last step: each edge's period between fires from the reference's P,
    # and its fire count from the period it was given
    it, G = max_iter - 1, watch.extra["G"]
    nn, fired = watch.extra["nn"].long(), watch.extra["fired"]
    edges = torch.arange(n, device=Xd.device)[:, None] * n + nn

    def periods(keys, P, dtype):
        p = ref_aff.lookup(keys, P, edges).to(dtype)
        P_max = P.max().to(dtype)
        return torch.where(p > P_max / max_iter, P_max / (p + 1e-3),
                           torch.full_like(p, float("inf"))).double()

    eps_ref = periods(ref_keys, ref_P, torch.float64)
    eps_got = periods(keys, vals, torch.bfloat16) if mode == CONTROL else watch.extra["eps"].double()
    live, live_got = torch.isfinite(eps_ref), torch.isfinite(eps_got)
    # a padding slot holds id 0 and an infinite period
    edge = (nn != 0) | torch.isfinite(watch.extra["eps"])
    rel = torch.where(live & live_got, (eps_got - eps_ref).abs() / eps_ref,
                      torch.ones_like(eps_ref))[(live | live_got) & edge]
    eps_gap = quantile(rel, 0.99)
    now = float(it + 1)

    def counts(eps, dtype):
        eps = eps.to(dtype)
        return (torch.floor(now / eps) - torch.floor(max(now - G, 0.0) / eps)).double()

    want = counts(eps_got, torch.float64)
    got = counts(eps_got, torch.bfloat16) if mode == CONTROL else fired.double()
    active = (want > 0) | (got > 0)
    fire_miss = float(((want != got) & active).sum() / active.sum().clamp(min=1))

    a, b = ref_grad.umap_ab(float(params.get("spread", 1.0)), float(params.get("min_dist", 0.1)))
    rate = float(params.get("negative_sample_rate", 5))
    Z_prev = watch.steps[it]
    args = (Z_prev, nn, fired, watch.extra["neg"], a, b, rate)
    g_ref = ref_grad.umap_step(*args) * watch.extra["ee"]
    g_got = ref_grad.umap_step(*args, dtype=torch.bfloat16) if mode == CONTROL else watch.grad
    grad_gap = widest_row_gap(g_got, g_ref)

    # plain SGD (no momentum) at LinearLR's rate of the last step
    lr = float(params.get("lr", 1.0)) * (1.0 - it / max_iter)
    Z_prev64 = Z_prev.double()
    want_step = -lr * g_ref
    if mode == CONTROL:
        Z_got = Z_prev - torch.tensor(lr, dtype=torch.float32) * g_got.float()
    else:
        Z_got = torch.as_tensor(Z_out, device=Xd.device)
    got_step = Z_got.double() - Z_prev64
    allow = ulp32(torch.maximum(Z_got.double().abs(), Z_prev64.abs()))
    step_gap = widest_row_gap(got_step, want_step, allow)
    return {"numbers": {"knn_miss": 1.0 - knn_recall, "p_gap": p_gap, "eps_gap": eps_gap,
                        "fire_miss": fire_miss,
                        "grad_gap": grad_gap, "step_gap": step_gap},
            "knn_recall": knn_recall}

"""t-SNE cells: how a fit is built and watched, and the numbers that judge it.

The numbers (limits in the cell's file):

- ``knn_miss``: 1 - recall@k (k = 3·perplexity) of the kNN graph on the
  sampled rows against their exact neighbours (float64 differences);
- ``p_gap``: the widest gap between a row of P the affinity phase ended
  with and the reference's, as a share of the row's largest entry, over
  the sampled rows whose kNN ids are the reference's (a row's P depends on
  its own neighbours alone; a row whose ids differ, a near-tie at the
  k-th neighbour, is ``knn_miss``'s to judge); 1 where no row's ids agree;
- ``grad_gap``: the last step's gradient against the reference's at the
  same embedding and affinity (the program's state at that step; the
  affinity is checked by the two numbers above), widest row, as a share of
  the row's size or the median row's. The gradient near convergence is a
  small difference of large terms, so the reference's own P, whose rows
  differ where a near-tie swaps a 90th neighbour, would move it there by a
  large share;
- ``step_gap``: the embedding ``fit_transform`` returned against the
  embedding before the last step moved by SGD with momentum (the momentum
  buffer read from the two embeddings before it) and the reference's
  gradient, beyond the float32 spacings that rounding leaves, as a share of
  the step.
"""

from __future__ import annotations

import torch

from perfbench.reference import affinity as ref_aff
from perfbench.reference import gradient as ref_grad
from perfbench.reference.knn import all_neighbours, neighbours_of_rows
from perfbench.reference.precision import CONTROL, REFERENCE, tf32_off
from perfbench.reference.quality import recall
from perfbench.watch import ulp32, widest_row_gap

#: the CUDA sources a t-SNE fit launches (K2, K3)
KERNEL_SOURCES = ("rowlse_fwd", "rowlse_bwd")
#: the momentum of SGD after early exaggeration ("auto" optimizer settings)
MOMENTUM = 0.8

#: the program's hooks the check rides on: what each field of the watch
#: comes from (a private hook that a change to the program stops calling
#: makes the check raise ``HookNotReached``, naming it)
HOOKS = {
    "knn_ids": "the input affinity's _distance_matrix(X, k, return_indices=True)",
    "knn_graph": "the input affinity's _distance_matrix(X, k, return_indices=True)",
    "p_ids": "on_affinity_computation_end (affinity_in_, NN_indices_)",
    "p_vals": "on_affinity_computation_end (affinity_in_, NN_indices_)",
    "steps": "TSNE._loss_gradients(Z, consts, carry, it, ee_coeff) at each of the last two steps",
    "grad": "TSNE._loss_gradients(Z, consts, carry, it, ee_coeff) at the last step",
    "extra": "TSNE._loss_gradients at the last step: consts['P'], consts['NN']",
}


def build(params: dict, random_state: int, device: str, watch):
    """The estimator, watched by ``watch`` (a :class:`perfbench.watch.Watch`)."""
    from torchdr_tpu_torch import TSNE

    class WatchedTSNE(TSNE):
        def on_affinity_computation_end(self):
            watch.keep_affinity(self.affinity_in_, self.NN_indices_)
            super().on_affinity_computation_end()

        def _loss_gradients(self, Z, consts, carry, it, ee_coeff):
            last = int(self.max_iter) - 1
            if it < last - 1:
                return super()._loss_gradients(Z, consts, carry, it, ee_coeff)
            watch.steps[it] = Z.detach().clone()
            grad, carry = super()._loss_gradients(Z, consts, carry, it, ee_coeff)
            if it == last:
                watch.grad = grad.clone()
                # the affinity the loop ran on (held, not copied)
                watch.extra = {"ee": ee_coeff, "P": consts["P"], "NN": consts["NN"]}
            return grad, carry

    model = WatchedTSNE(random_state=random_state, device=device, **params)
    watch.wrap_knn(model.affinity_in)
    return model


def shapes(model, watch) -> dict:
    """The fit's shapes for K2's and K3's bounds."""
    last = int(model.max_iter) - 1
    watch.need(HOOKS, steps=(last,))
    n, d = watch.steps[max(watch.steps)].shape
    return {"n": n, "d": d, "kernel": "student"}


def judge(params: dict, X, Z_out, watch, device, mode: str = REFERENCE) -> dict:
    """The numbers of the last fit (``mode=REFERENCE``), or those of the
    control put in the program's place (``mode=CONTROL``)."""
    with tf32_off():
        return _judge(params, X, Z_out, watch, device, mode)


def _judge(params, X, Z_out, watch, device, mode):
    perplexity = float(params.get("perplexity", 30))
    k = int(3 * perplexity)
    max_iter = int(params.get("max_iter", 2000))
    ee_iter = int(params.get("early_exaggeration_iter", 250))
    if not max_iter - 2 > ee_iter:
        raise ValueError("perfbench: the last two steps must follow early exaggeration")
    watch.need(HOOKS, "knn_ids", "p_ids", "p_vals", "grad", "extra",
               steps=(max_iter - 1, max_iter - 2))
    Xd = torch.as_tensor(X, device=device)
    n = Xd.shape[0]
    rows = watch.rows
    _, exact = neighbours_of_rows(Xd, rows, k)

    D, ids = all_neighbours(Xd, k)
    P_ref = ref_aff.entropic_rows(D, perplexity)
    ref_keys, ref_vals = ref_aff.directed_keys(ids, P_ref)
    if mode == CONTROL:
        Dc, ids_got = all_neighbours(Xd, k, CONTROL)
        P_got = ref_aff.entropic_rows(Dc.float(), perplexity)
        knn_ids = p_ids = ids_got[rows]
        got_P = ref_aff.padded_rows(n, rows, p_ids, P_got[rows])
    else:
        knn_ids, p_ids = watch.knn_ids, watch.p_ids
        got_P = ref_aff.padded_rows(n, rows, p_ids, watch.p_vals)
    knn_recall = float(recall(knn_ids, exact).mean())
    same = (p_ids.long().sort(1).values == ids[rows].long().sort(1).values).all(1)
    gaps = ref_aff.row_gaps(n, rows, got_P, ref_keys, ref_vals)[same]
    p_gap = float(gaps.max()) if gaps.numel() else 1.0

    it = max_iter - 1
    Z_prev, Z_prev2 = watch.steps[it], watch.steps[it - 1]
    P_loop, NN_loop = watch.extra["P"], watch.extra["NN"]
    g_ref = ref_grad.tsne_step(Z_prev, P_loop, NN_loop)
    if mode == CONTROL:
        g_got = ref_grad.tsne_step(Z_prev, P_loop, NN_loop, dtype=torch.bfloat16)
    else:
        g_got = watch.grad
    grad_gap = widest_row_gap(g_got, g_ref)

    # SGD with momentum at lr "auto" after early exaggeration: the buffer
    # times lr is the last move, Z(T-2) - Z(T-1)
    lr = max(n / 4.0, 50.0)
    Z_prev64, Z_prev2_64 = Z_prev.double(), Z_prev2.double()
    want_step = MOMENTUM * (Z_prev64 - Z_prev2_64) - lr * g_ref
    if mode == CONTROL:
        buf = (Z_prev2 - Z_prev) / torch.tensor(lr, dtype=torch.float32)
        Z_got = Z_prev - torch.tensor(lr, dtype=torch.float32) * (MOMENTUM * buf + g_got.float())
    else:
        Z_got = torch.as_tensor(Z_out, device=Xd.device)
    got_step = Z_got.double() - Z_prev64
    size = torch.maximum(torch.maximum(Z_got.double().abs(), Z_prev64.abs()), Z_prev2_64.abs())
    step_gap = widest_row_gap(got_step, want_step, (1.0 + MOMENTUM) * ulp32(size))
    return {"numbers": {"knn_miss": 1.0 - knn_recall, "p_gap": p_gap, "grad_gap": grad_gap,
                        "step_gap": step_gap},
            "knn_recall": knn_recall}

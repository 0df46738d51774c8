"""knn_recall (ratio): recall@k of the kNN graph the last fit's affinity
built, on the sampled rows, against their exact neighbours (the check
computes it)."""


def read(ctx):
    judged = ctx["judged"]
    return None if judged is None else judged["knn_recall"]

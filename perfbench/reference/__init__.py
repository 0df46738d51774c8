"""The plain reference that decides whether a run of the benchmark is correct.

Plain PyTorch in float64 (or NumPy), written from the published
definitions and not from the program: exact neighbours (:mod:`.knn`),
UMAP's fuzzy affinity and t-SNE's perplexity-calibrated affinity
(:mod:`.affinity`), one optimizer step's gradient (:mod:`.gradient`),
trustworthiness and recall (:mod:`.quality`). It imports nothing of the
program, of ``torchdr_tpu`` or of JAX, and takes nothing the program made but
the state it judges. :mod:`.precision` gives the lower precisions its
control runs in. Nothing here runs a TF32 product: the products are float64,
or float32 with inputs that :func:`.precision.tf32_round` rounded as the
tensor cores would.
"""

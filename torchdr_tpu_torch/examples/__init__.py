"""The examples gallery of the port (counterpart of the repository's
``examples/``): one script per file, in the same folders under the same
names, each run as ``python -m torchdr_tpu_torch.examples.<folder>.<name>``.

Each script prints what its JAX counterpart prints, runs on the card unless
given ``--device cpu``, and holds its results to a gate (``_common.py``),
raising when one fails. Its ``main(argv)`` returns a dict: the printed
numbers and, for each fit, the embedding and its labels where the data have
labels. ``python -m torchdr_tpu_torch.examples`` runs every script in a
fresh process (``__main__.py``).
"""

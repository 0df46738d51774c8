"""fit_s.device_bound (s): ``fit_s`` in the cells whose fits the card bounds
(device idle ≤ 0.1), where the host's speed, which moves the host-bound
cells' fits by up to 10 % from one process to the next, barely reaches, so
the bound can be tight."""

from perfbench.metrics.fit_s import read  # noqa: F401

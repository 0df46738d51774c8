"""Each test process keeps to two threads: the tests run several processes
at once, and torch's default of one thread a core would oversubscribe the
machine many times over."""

import torch

torch.set_num_threads(2)

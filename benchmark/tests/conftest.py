"""The benchmark's own tests: run from the repository's root with
`python -m pytest benchmark/tests -q` (CPU) and, on the card,
`python -m pytest benchmark/tests -q -m cuda`. Nothing here imports JAX."""

import torch

torch.set_num_threads(2)

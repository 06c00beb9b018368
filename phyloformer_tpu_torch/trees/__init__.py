from .likelihood import log_likelihood, log_likelihood_ratio
from .nj import neighbor_joining

__all__ = [
    "log_likelihood",
    "log_likelihood_ratio",
    "neighbor_joining",
]

# heavier imports, on demand (the C++ library is built at first use):
#   from phyloformer_tpu_torch.trees import native     — BME/NNI/SPR + comparisons
#   from phyloformer_tpu_torch.trees import baselines  — Hamming/ML-FastME, FastTree

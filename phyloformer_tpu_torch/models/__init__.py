from .params import Params, PhyloformerConfig, count_params, params_from_numpy
from .phyloformer import forward

__all__ = ["Params", "PhyloformerConfig", "count_params", "forward", "params_from_numpy"]

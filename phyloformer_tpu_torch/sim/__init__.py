from .models import SubstitutionModel, discrete_gamma_rates, get_model, load_paml_dat
from .msa import MsaSimConfig, evolve_alignment, simulate_msa
from .priors import QuantileSampler, alpha_sampler, diameter_sampler
from .trees import TreeSimConfig, simulate_tree, simulate_trees

__all__ = [
    "MsaSimConfig",
    "QuantileSampler",
    "SubstitutionModel",
    "TreeSimConfig",
    "alpha_sampler",
    "diameter_sampler",
    "discrete_gamma_rates",
    "evolve_alignment",
    "get_model",
    "load_paml_dat",
    "simulate_msa",
    "simulate_tree",
    "simulate_trees",
]

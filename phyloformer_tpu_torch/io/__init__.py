from .checkpoint import CheckpointManager, load_params_npz, save_params_npz
from .ckpt_import import load_pretrained, params_from_state_dict

__all__ = ["CheckpointManager", "load_params_npz", "load_pretrained", "params_from_state_dict",
           "save_params_npz"]

from .ckpt_import import load_pretrained, params_from_state_dict

__all__ = ["load_pretrained", "params_from_state_dict"]

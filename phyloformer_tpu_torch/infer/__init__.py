from .engine import InferenceConfig, InferenceEngine

__all__ = ["InferenceConfig", "InferenceEngine"]

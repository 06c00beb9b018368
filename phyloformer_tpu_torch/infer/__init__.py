from .engine import InferenceConfig, InferenceEngine, ShardedInferenceEngine

__all__ = ["InferenceConfig", "InferenceEngine", "ShardedInferenceEngine"]

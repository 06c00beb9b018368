from .server import InferenceServer, MicroBatcher

__all__ = ["InferenceServer", "MicroBatcher"]

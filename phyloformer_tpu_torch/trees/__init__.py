from .nj import neighbor_joining

__all__ = ["neighbor_joining"]

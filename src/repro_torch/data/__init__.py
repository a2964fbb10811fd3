from .pointsets import blocked_clusters, load_pointset, synthetic_pointset

__all__ = ["blocked_clusters", "load_pointset", "synthetic_pointset"]

from .pointsets import blocked_clusters, synthetic_pointset

__all__ = ["blocked_clusters", "synthetic_pointset"]

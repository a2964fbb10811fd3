from .paper_nng import NNG_CONFIGS, NNGConfig

__all__ = ["NNG_CONFIGS", "NNGConfig"]

from .pipeline import SyntheticTokens, make_pipeline

__all__ = ["SyntheticTokens", "make_pipeline"]

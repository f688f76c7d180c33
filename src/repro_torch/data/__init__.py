"""Data substrate of the port: the deterministic synthetic token
pipeline."""
from .pipeline import DataConfig, SyntheticTokenPipeline

__all__ = ["DataConfig", "SyntheticTokenPipeline"]

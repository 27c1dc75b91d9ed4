"""Device operations shared by the hot compute paths."""

from .topk import partial_top_k

__all__ = ["partial_top_k"]

from eioku_tpu_torch.index.semantic import SemanticIndex

__all__ = ["SemanticIndex"]

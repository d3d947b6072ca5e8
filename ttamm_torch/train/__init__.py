from .step import encode_corpus

__all__ = ["encode_corpus"]

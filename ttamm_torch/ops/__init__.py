from .topk import mips_topk

__all__ = ["mips_topk"]

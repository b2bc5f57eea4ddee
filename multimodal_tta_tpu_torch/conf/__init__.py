from .node import ConfigNode

__all__ = ["ConfigNode"]

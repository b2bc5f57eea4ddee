"""Hand-written Hopper kernels of the port, one module per TPU kernel of the
JAX package, each with its plain PyTorch version beside it."""

from .fused_instance_norm import fused_instance_norm, instance_norm_plain

__all__ = ["fused_instance_norm", "instance_norm_plain"]

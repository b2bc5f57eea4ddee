"""Hand-written Hopper kernels of the port, one module per TPU kernel of the
JAX package, each with its plain PyTorch version beside it. Importing the
package registers both as torch operators (``torch.ops.mtta.*``), which a
saved serving artifact needs before it loads."""

from .edt_minplus import minplus, minplus_plain, squared_edt_volumes, squared_edt_volumes_plain
from .fused_instance_norm import fused_instance_norm, instance_norm_plain

__all__ = ["fused_instance_norm", "instance_norm_plain", "minplus", "minplus_plain",
           "squared_edt_volumes", "squared_edt_volumes_plain"]

"""Host data plumbing of the port: NIfTI I/O, the HECKTOR21 and BraTS dataset
builders, the threaded host loader, the segmentation transforms, the
host-to-device prefetch and the device-resident cache."""

from . import nifti
from .base_builder import BaseDatasetBuilder
from .loader import HostLoader, default_collate
from .prefetch import prefetch_to_device
from .transforms import SegTransform, get_seg_transforms, normalize_host

# Import for registration side effects.
from . import hecktor21  # noqa: F401,E402
from . import brats  # noqa: F401,E402

__all__ = ["nifti", "BaseDatasetBuilder", "HostLoader", "default_collate", "prefetch_to_device",
           "SegTransform", "get_seg_transforms", "normalize_host"]

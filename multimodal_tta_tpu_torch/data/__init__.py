"""Host data plumbing of the port: the threaded host loader, the
segmentation transforms, the dataset-builder base and the host-to-device
prefetch."""

from .base_builder import BaseDatasetBuilder
from .loader import HostLoader, default_collate
from .prefetch import prefetch_to_device
from .transforms import SegTransform, get_seg_transforms, normalize_host

__all__ = ["BaseDatasetBuilder", "HostLoader", "default_collate", "prefetch_to_device",
           "SegTransform", "get_seg_transforms", "normalize_host"]

from . import lists, pipeline, synthetic
from .pipeline import (Loader, SegDataset, device_prefetch, normalize_image,
                       normalize_label)

from . import lists, pipeline, synthetic
from .pipeline import Loader, SegDataset, normalize_image

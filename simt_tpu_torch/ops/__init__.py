from .interp import upsample_bilinear_align_corners
from .metrics import fast_hist, label_mapping, mean_iou, per_class_iu

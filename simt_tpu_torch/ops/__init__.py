from .interp import upsample_bilinear_align_corners
from .metrics import fast_hist, fast_hist_np, label_mapping, mean_iou, per_class_iu

from .evaluate import PALETTE, colorize_mask, evaluate, make_eval_fn, save_pred_png

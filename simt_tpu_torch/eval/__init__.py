from .evaluate import evaluate, make_eval_fn, save_pred_png

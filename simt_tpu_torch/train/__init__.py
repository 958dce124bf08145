from . import checkpoint
from .loop import build_loader, build_models, train
from .simt import SimTStep, create_simt_state, make_simt_step
from .state import SimTState, WarmupState, param_label
from .warmup import WarmupStep, create_warmup_state, make_warmup_step

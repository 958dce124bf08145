from .simt import SimTStep, create_simt_state, make_simt_step
from .state import SimTState, param_label

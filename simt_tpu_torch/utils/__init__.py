from .logging import MetricWriter, StepTimer, format_simt_line, format_warmup_line
from .viz import plot_ntm

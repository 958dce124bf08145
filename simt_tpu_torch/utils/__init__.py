from .logging import format_simt_line, format_warmup_line

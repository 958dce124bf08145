from .logging import format_simt_line

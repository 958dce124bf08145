"""The port's benchmark: one run of one cell of ``BENCHMARK.json`` on this machine.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``: from the start of this module, imports, weights and inputs made on
the device from the seed, the first steps that warm every shape and build the port's
kernels) comes first, then the measured window of ``--seconds``; with ``--trace 1`` the
program's spans and one profiler session follow. Once the program's state is freed, the
plain reference checks what the timed path produced.

The last line on stdout is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared beside its limit, which are also the last lines on stderr. Everything else
goes to stderr. Without a CUDA card, or with fewer cards than the cell asks for,
without the port, or if JAX or the JAX package got loaded, it prints no result and
exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches at fixed paths inside the checkout (the port's own kernels
# build under build/kernels).
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        import simt_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"benchmark: the port simt_tpu_torch is not importable here: {e}")
        return 2
    import torch

    from . import harness

    on_card = torch.cuda.is_available()
    run = harness.Run(args.workload, args.seed, "cuda" if on_card else "cpu")
    chips = int(run.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} card(s)")
        return 2
    out = harness.run_cell(run, args.seconds, bool(args.trace), T_START)
    result, rec = out["result"], out["rec"]
    bad = harness.forbidden_modules()
    if bad:
        log("benchmark: JAX or the JAX package was loaded: " + ", ".join(bad))
        return 3
    numbers = {k: v for k, v in rec["numbers"].items() if k not in result["checks"]}
    parts = ", ".join(f"{k} {v:.3f} s" for k, v in rec["setup_parts"].items())
    log(f"benchmark: {args.workload} seed {args.seed}: setup {rec['setup_s']:.3f} s "
        f"({parts}), "
        f"window {rec['window']['wall_s']:.3f} s, {result['attempted']} attempted, "
        f"{result['failed']} failed; other readings {json.dumps(numbers)}")
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

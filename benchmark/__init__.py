"""The benchmark of ``simt_tpu_torch`` on one H100: the cells of ``BENCHMARK.json`` at
the repository's root.

    python3 -m benchmark.run --workload simt_train_b16 --seed 7 --seconds 30 --trace 0
    python3 -m benchmark.tools.control --workload simt_train_b16 --program-seeds 1,2 \\
        --control-seeds 3                     the readings the limits are set from
    python3 -m benchmark.flops deeplabv2_multi_r101_simt     the FLOPs an image
    python -m pytest benchmark/tests -q        the benchmark's own tests (CPU); on a card
                                               the ``chip``-marked ones run too

``harness.py`` says how the files are found by name. Nothing here imports JAX or the
JAX package; ``reference/`` imports nothing of the port.
"""

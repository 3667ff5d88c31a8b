"""The benchmark of vanderbei_tpu_torch, the PyTorch/CUDA port.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once and prints one JSON result line.  The
harness is driven by data: a configuration is benchmark/configs/<name>.json,
a traffic mix benchmark/traffic/<name>.json, a cell's correctness limits
benchmark/cells/<name>.json, and each metric a reader
benchmark/metrics/<name>.py, all found by the names in BENCHMARK.json.

Nothing here imports jax or the JAX package; the yardstick (LP generator,
plain reference solver, trace reduction, roofline counts) imports nothing
of the port either.
"""

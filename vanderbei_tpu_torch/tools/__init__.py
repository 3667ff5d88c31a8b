"""Measurement scripts for the port on a CUDA card, run by path:

    python3 vanderbei_tpu_torch/tools/ab_solve.py ...     # two trees, A/B
    python3 vanderbei_tpu_torch/tools/mesh_solve.py ...   # tensor-parallel

ab_solve.py reads the smoke MPS files that chip_smoke.py writes under
_build/smoke; mesh_solve.py takes an MPS file or makes the smoke LP.
Times of whole solves come from the benchmark (benchmark/run.py).
"""

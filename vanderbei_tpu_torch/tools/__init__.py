"""Measurement scripts for the port on a CUDA card, run by path:

    python3 vanderbei_tpu_torch/tools/profile_solves.py   # warm solves + trace
    python3 vanderbei_tpu_torch/tools/ab_solve.py ...     # two trees, A/B

Both read the smoke MPS files that chip_smoke.py writes under _build/smoke.
"""

"""portbench: the benchmark of the PyTorch and CUDA port (``c_lwe_snarks_tpu_torch``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It drives the port on one card and nothing else: no module here imports JAX
or the JAX package, and ``reference/`` imports nothing of the port.
"""

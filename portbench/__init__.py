"""Benchmark of ``multilinear_tpu_torch``, the PyTorch and CUDA prover.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once.  A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``, with its adapter to the program and its plain
reference) and the parameters of its traffic; a per-layer metric is a reader
of its own (``metrics/<metric>.py``).  The harness finds them by name.
"""

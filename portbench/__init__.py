"""The benchmark of ``fasta_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line; ``portbench/README.md`` says how the pieces fit.  Nothing here
imports JAX or the JAX package ``fasta_tpu``.
"""

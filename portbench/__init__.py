"""The benchmark of ``multigrid_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints its result
as the last line of standard output. Nothing here imports JAX or the JAX
package.
"""

"""The benchmark of the PyTorch and CUDA tracker, ``botsort_tpu_torch``.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of BENCHMARK.json once on the card and
prints one JSON line (README.md in this folder).
"""

"""The H100 benchmark of ``pygat_tpu_torch``, driven by the data beside it.

``python -m h100_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of the root ``BENCHMARK.json``. Everything a
cell uses is found by name: its configuration (``configs/``), its cell file
(``workloads/``), its traffic mix (``traffic/<mix>.json``, read by the
generator ``traffic/<generator>.py``), the loop it drives
(``drivers/<loop>.py``), its per-layer metrics (``metrics/<metric>.py``),
the bytes of each kernel (``bounds/<kernel>.py``), the FLOPs of its model
(``flops/<model>.py``) and its plain reference (``reference/``). Nothing
here imports JAX or the JAX package, and ``reference/`` imports nothing of
the port.
"""

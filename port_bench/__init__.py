"""The benchmark of the PyTorch and CUDA port of the MRI nanoparticle
simulator (``mri_nanoparticle_simulation_tpu_torch``).

    python3 -m port_bench --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell on one card and prints one JSON line: whether the timed
path's output matched the plain reference (``reference/``), and the
cell's end-to-end metrics (``--trace 0``) or per-layer metrics from a
profiler trace (``--trace 1``).  Configurations, cells, drivers and
metrics are files found by name (``catalog.py``).
"""

"""The port's benchmark: the PyTorch and CUDA package on the H100, driven
by data. ``BENCHMARK.json`` at the repository's root lists its cells and
metrics; ``python -m portbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (``run.py``). It imports nothing of the
JAX package, JAX or Flax."""

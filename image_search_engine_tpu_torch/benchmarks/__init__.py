"""Ports of the JAX repo's kernel-exploration scripts (``benchmarks/``) and
what they share with the bench twin (``common.py``). Each runs as
``python -m image_search_engine_tpu_torch.benchmarks.<name>`` on the card,
or with ``--device cpu`` and small ``--n``, ``--q``, ``--iters`` on the
kernels' plain versions."""

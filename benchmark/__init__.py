"""The benchmark of ``kmergma_tpu_torch`` on one NVIDIA H100.

``run.py`` is the command; ``harness`` generates the inputs, drives the
program and reads the metrics; ``reference`` is the plain re-derivation
of the hit records that decides ``correct``; ``configs``, ``traffic`` and
``metrics`` hold one file per configuration, traffic mix and metric, found
by the names in ``BENCHMARK.json``.  Nothing here imports JAX or the JAX
package, and ``reference`` imports nothing of the program.
"""

"""The benchmark of ``nextbestpath_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything a cell
uses is found by name: its configuration in ``configs/<name>.json``, its
traffic in ``mixes/<name>.json``, the driver of the mix's ``kind`` in
``drivers/<kind>.py`` and each per-layer metric's reader in
``metrics/<name>.py``. The yardstick (the FLOP and byte counts, the peaks,
the trace arithmetic and the plain references in ``reference/``) lives
here and imports nothing of the JAX package.
"""

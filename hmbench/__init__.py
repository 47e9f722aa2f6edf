"""The benchmark of hetmogp_tpu_torch: ``python3 -m hmbench.run``.

Driven by data: ``BENCHMARK.json`` names each cell's configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``, read by
``kinds/<kind>.py``), limits (``limits/<cell>.json``) and per-layer
metrics (``layer_metrics/<name>.py``); see README.md.
"""

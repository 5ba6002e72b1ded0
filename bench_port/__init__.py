"""The benchmark of peng_motif_tpu_torch (see ``run.py``).  Its tests:
``python -m pytest bench_port/tests -q`` from the checkout's root."""

"""One reader per metric, ``<metric>.py`` with ``read(rec)``: the value,
or None where the run holds nothing to read.  ``rec`` is the run's
record: ``jobs`` (the window's jobs: ``wall`` s, ``phases`` {name: s}
from ``--timing``), ``window_s``, ``setup_s``, ``launches`` (histogram
kernel launches in the window), ``device_kind``, ``trace`` (with
``--trace 1``: ``busy_s``, ``window_s``, ``hist_s``, ``hist_calls``
[(inputs, bins)], ``jobs``) or None, and the set-up's: ``warmup`` (the
jobs before the window, in the order run, as ``jobs`` but without the
count table), ``context_s`` (the harness's CUDA context, made and
synchronised; 0 off the card) and ``setup_marks`` {step: the process's
age in s after it}: "main" (the interpreter and the harness's module),
"torch" (its import), "cuda_check" (``torch.cuda.is_available``),
"program" (``import peng_motif_tpu_torch``) where ``main`` ran, then
"imports" (the run's imports of the program and the check), "context",
"card" (nvidia-smi), "corpus" (with the traffic's set-up job) and
"first_warmup"."""

"""One reader per metric, ``<metric>.py`` with ``read(rec)``: the value,
or None where the run holds nothing to read.  ``rec`` is the run's
record: ``jobs`` (the window's jobs: ``wall`` s, ``phases`` {name: s}
from ``--timing``), ``window_s``, ``setup_s``, ``launches`` (histogram
kernel launches in the window), ``device_kind``, and ``trace`` (with
``--trace 1``: ``busy_s``, ``window_s``, ``hist_s``, ``hist_calls``
[(inputs, bins)], ``jobs``) or None."""

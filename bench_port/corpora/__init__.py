"""Corpus generators, one module each, found by the ``generator`` name a
configuration file gives.  Each has ``write(path, params, seed, root)
-> bases``: the corpus it makes from ``params`` and ``seed`` (files it
reads are named relative to the checkout ``root``), written as FASTA to
``path``; the same seed gives the same bytes."""

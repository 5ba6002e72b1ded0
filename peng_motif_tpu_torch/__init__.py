"""peng_motif_tpu_torch: de-novo DNA motif discovery on PyTorch and CUDA.

The PyTorch/CUDA port of ``peng_motif_tpu`` (a reimplementation of the
capabilities of soedinglab/PEnG-motif).  Every 4**W-table phase — count,
stats, climb, PWM, EM — runs on the selected torch device; the count's
histogram is a hand-written CUDA kernel on an NVIDIA H100 (sm_90a).
Parsing, seed selection, the climb's seen-set replay and merging run on
the host, partly in the native C++ library.  This package imports
torch, numpy and the standard library only.
"""

__version__ = "1.0.0"

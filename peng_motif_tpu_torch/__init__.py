"""peng_motif_tpu_torch: de-novo DNA motif discovery on PyTorch and CUDA.

The PyTorch/CUDA port of ``peng_motif_tpu`` (a reimplementation of the
capabilities of soedinglab/PEnG-motif).  The count phase runs on the
selected torch device, its histogram as a hand-written CUDA kernel on an
NVIDIA H100 (sm_90a); the later phases run on byte-exact host twins in
the native C++ library.  This package imports torch, numpy and the
standard library only.
"""

__version__ = "1.0.0"

"""PyTorch and CUDA port of bucketeer_tpu's JPEG 2000 codec.

TIFF -> JP2 through :class:`converters.cuda.CudaConverter`, with the
sample transform in PyTorch and EBCOT Tier-1 on hand-written Hopper
kernels: fused (``csrc/fused_t1.cu``), or split into the device CX/D
scan (``csrc/cxd_scan.cu``) and a host MQ replay; or on the host's
cores (``csrc/host_t1.cpp``, which also holds the split's replay) over
bit planes packed on the card.
JP2 -> pixels through :class:`converters.reader.CudaReader` (and
``codec.decode.decode``): Tier-2 and Tier-1 decode on the host, the
inverse transform as torch ops on the card.
The package imports ``torch`` and ``numpy`` and nothing of the JAX
package; its entry points run on the card unless the caller passes
``device="cpu"``.
"""

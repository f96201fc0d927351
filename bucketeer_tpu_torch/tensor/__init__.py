"""Compressed-domain tensor delivery: the second workload the Tier-1
kernels serve.

Two products:

- :func:`decode_to_coefficients` — stop the image decode after Tier-1
  + dequantization and return per-subband coefficient tensors on the
  caller's device (tensor/coeffs.py), composable with the stream index
  for sharded random-access region reads;
- the general bit-plane tensor codec — :func:`encode_tensor` /
  :func:`decode_tensor` / :func:`truncate_tensor` route arbitrary
  int/float tensors through the block partitioner and the fused CX/D +
  MQ Tier-1 kernel on the card into a self-describing progressive
  container (tensor/codec.py, tensor/container.py, tensor/planes.py).
"""
from .codec import (decode_tensor, encode_tensor, set_metrics_sink,
                    tensor_services, tensor_stats, truncate_tensor)
from .coeffs import (CoefficientSet, coeff_services,
                     decode_to_coefficients)

__all__ = ["encode_tensor", "decode_tensor", "truncate_tensor",
           "tensor_stats", "tensor_services", "coeff_services",
           "set_metrics_sink", "decode_to_coefficients",
           "CoefficientSet"]

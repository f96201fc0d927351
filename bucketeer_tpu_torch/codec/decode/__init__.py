"""JP2 decode — the read path, the mirror of the encoder, and the
port's own round-trip oracle (no OpenJPEG in the loop):

- ``parser``   Tier-2: JP2 boxes, markers, packet headers (host)
- ``index``    code-block-addressable stream index (random access)
- ``t1_dec``   MQ + EBCOT context-modeling pass decode (host)
- ``device``   dequantize + inverse DWT + inverse RCT/ICT (torch, on
               the card unless the caller asks for the CPU)
- ``decoder``  orchestration, partial decode (``reduce`` / ``layers``),
               windowed region decode (``region`` / ``index``)

Public API: :func:`decode`, :func:`probe`, :func:`build_index`,
:class:`StreamIndex`, :class:`DecodeError`, :class:`InvalidParam`,
:func:`set_metrics_sink`.
"""
from .decoder import decode, set_metrics_sink
from .errors import DecodeError, InvalidParam
from .index import StreamIndex, build_index
from .parser import probe

__all__ = ["decode", "probe", "build_index", "StreamIndex",
           "DecodeError", "InvalidParam", "set_metrics_sink"]

"""repro_torch.compress — the codec subsystem: one quantizer, many consumers.

  codec    (*what* is sent)   — :class:`QSGDCodec` (Assumption-1 stochastic
           levels) and :class:`IdentityCodec` (s = ∞);
  backend  (*how* it is computed) — reference "torch" math or the
           hand-written "cuda" kernels of :mod:`repro_torch.kernels.qsgd`;
  wire     (*what it costs*) — the bit accounting of
           :mod:`repro_torch.compress.wire`, which the cost layer prices
           through ``codec.wire_bits`` so the optimizer and the runtime
           agree on every bit.
"""
from . import elias
from .backends import (decode, decode_apply_cuda, encode, encode_cuda,
                       level_dtype, qsgd_levels)
from .codec import (CODEC_BACKENDS, Codec, IdentityCodec, QSGDCodec,
                    bits_per_message, make_codec, q_pair, variance_bound)
from .wire import (RUNTIME_WIRES, WIRE_FORMATS, level_bits, wire_bits,
                   wire_max_s)

__all__ = [
    "Codec", "QSGDCodec", "IdentityCodec", "CODEC_BACKENDS", "make_codec",
    "encode", "decode", "encode_cuda", "decode_apply_cuda", "qsgd_levels",
    "level_dtype", "variance_bound", "bits_per_message", "q_pair",
    "WIRE_FORMATS", "RUNTIME_WIRES", "wire_bits", "level_bits",
    "wire_max_s", "elias",
]

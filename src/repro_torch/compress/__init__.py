"""repro_torch.compress — the codec subsystem: one quantizer, many consumers.

  codec    (*what* is sent)   — :class:`QSGDCodec` (Assumption-1 stochastic
           levels), :class:`RotatedQSGDCodec` (randomized-Hadamard
           preconditioning, GQFedWAvg's quantizer) and
           :class:`IdentityCodec` (s = ∞);
  backend  (*how* it is computed) — reference "torch" math or the
           hand-written "cuda" kernels of :mod:`repro_torch.kernels.qsgd`,
           :mod:`repro_torch.kernels.fused_encode` and
           :mod:`repro_torch.kernels.elias`;
  wire     (*what it costs*) — the bit accounting of
           :mod:`repro_torch.compress.wire`, which the cost layer prices
           through ``codec.wire_bits`` so the optimizer and the runtime
           agree on every bit.

The encode side has a one-pass pipeline: ``Codec.encode_payload`` goes
straight from message to wire payload — the fused norm+quantize+pack
kernel for "int4" (``encode_fused``, with a rotate-fused variant for the
rotated codec) instead of separate norm / quantize / pack passes.
"""
from . import elias
from .backends import (FUSED_ROTATE_MAX_DIM, decode, decode_apply_cuda,
                       decode_tensor, encode, encode_cuda, encode_fused,
                       encode_fused_torch, encode_rotated_fused,
                       encode_tensor, level_dtype, qsgd_levels)
from .codec import (CODEC_BACKENDS, CODEC_KINDS, Codec, ErrorFeedbackCodec,
                    IdentityCodec, QSGDCodec, RotatedQSGDCodec,
                    bits_per_message, make_codec, q_pair, variance_bound)
from .rotation import fwht, next_pow2, rotate, unrotate
from .wire import (RUNTIME_WIRES, WIRE_FORMATS, level_bits, pack_int4,
                   unpack_int4, wire_bits, wire_max_s)

__all__ = [
    "Codec", "QSGDCodec", "IdentityCodec", "RotatedQSGDCodec",
    "ErrorFeedbackCodec", "CODEC_BACKENDS", "CODEC_KINDS", "make_codec",
    "encode_tensor", "decode_tensor",
    "encode", "decode", "encode_cuda", "decode_apply_cuda", "qsgd_levels",
    "level_dtype", "encode_fused", "encode_fused_torch",
    "encode_rotated_fused", "FUSED_ROTATE_MAX_DIM",
    "variance_bound", "bits_per_message", "q_pair",
    "WIRE_FORMATS", "RUNTIME_WIRES", "wire_bits", "level_bits",
    "wire_max_s", "pack_int4", "unpack_int4",
    "rotate", "unrotate", "fwht", "next_pow2", "elias",
]

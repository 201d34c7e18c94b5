"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit; a card set below it runs slower under load, so each run
records its limit beside the shares it reports).

The FLOP peak is the fastest float32-accurate rate of the card: three TF32
tensor-core products per float32 product (split operands), a third of the
495 TFLOP/s TF32 rate.  The configurations run float32 with TF32 off.
"""
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_F32_FLOP_PER_S = PEAK_TF32_FLOP_PER_S / 3

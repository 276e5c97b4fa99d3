"""Calibrated re-encoding: error-feedback (GPTQ) quantization and
sensitivity-driven mixed precision for the runtime formats.

Port of ``vptq_tpu/quant``: instead of rounding each weight group on its
own (RTN), the re-encode uses calibration activations to (a) feed each
column's rounding error back onto the columns not yet rounded, against
the layer's input second moment (``gptq``), and (b) keep in int8 the
sites, or the input columns, whose re-encode moves the output most
(``calibrate.quantize_model_calibrated``).
"""

from vptq_tpu_torch.quant.calibrate import (
    quantize_model_calibrated,
    synthetic_calibration_tokens,
)
from vptq_tpu_torch.quant.gptq import gptq_quantize

__all__ = [
    "gptq_quantize",
    "quantize_model_calibrated",
    "synthetic_calibration_tokens",
]

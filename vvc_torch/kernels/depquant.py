"""Dependent quantization constants (VVC's 4-state trellis quantizer).

Only the trellis λ is carried here: the native reconstruction core takes
it on every call (`vvc_torch.packer.native_recon`), although dependent
quantization itself stays off until its slice opens.
"""
from __future__ import annotations

# λ in normalized half-step units (λ·Δ⁻² is QP-independent), used with the
# measured level-rate table of vvc_torch.cabac.rates (vvc/kernels/depquant.py).
LAMBDA_T = 0.45

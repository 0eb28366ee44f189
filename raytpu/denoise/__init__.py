"""Differentiable denoising of rendered images.

The reference post-processes with Intel Open Image Denoise's pretrained
"RT" filter over (color, albedo, normal) buffers
(/root/reference/denoiser.h:31-91, invoked main.c:455), a black-box C
library call on already-quantized 0-255 colors (denoiser.h:41-46).

The replacement is a *differentiable* joint-bilateral filter
over the same three AOVs, in linear float (quantization happens once at
file write — documented, strictly-better divergence, SURVEY.md §7). It
is pure jnp (static window unrolled into shifted adds — XLA fuses the
whole filter into one elementwise pipeline), runs on device, and
gradients flow through it, so inverse rendering can optimize through the
denoised image exactly as the north star requires.
"""

from raytpu.denoise.bilateral import DenoiseParams, denoise

__all__ = ["DenoiseParams", "denoise"]

# also available: raytpu.denoise.learned.denoise_learned — the trained
# kernel-predicting CNN; raytpu.denoise.quality — PSNR/SSIM scoring.

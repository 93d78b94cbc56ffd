"""Reconstruction ops of the port: kernels K2 (dequant + IDCT), K3 (fused
upsample + color, planar) and K4 (4:4:4 stores -> planar RGB), block ->
plane layout, chroma upsampling and color conversion, in PyTorch."""

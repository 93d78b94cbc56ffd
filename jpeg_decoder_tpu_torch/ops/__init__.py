"""Reconstruction ops of the port: kernel K2 (dequant + IDCT), block ->
plane layout, chroma upsampling and color conversion, in PyTorch."""

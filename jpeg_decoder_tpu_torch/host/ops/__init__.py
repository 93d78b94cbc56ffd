"""Host reconstruction of the copy (numpy): IDCT, upsampling, color,
lossless predictors, and which planar tail a geometry takes."""

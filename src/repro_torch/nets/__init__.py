"""Dense teachers and their pegasusification (MLP-B in this slice)."""

"""The benchmark's plain references: PyTorch only, in float64 (and the
TF32 control). Nothing here imports the program under test."""

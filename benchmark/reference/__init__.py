"""The benchmark's plain reference: fp32 PyTorch and numpy, importing
nothing of the program it judges."""

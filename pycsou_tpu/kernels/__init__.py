"""Plain-XLA building blocks of the hot loops: banded convolution passes
(band.py) and the fused TV stencil step (tv.py)."""

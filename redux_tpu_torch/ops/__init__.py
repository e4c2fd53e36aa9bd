"""The port's device operations: K1 (``model``), K2 and K4 (``encode``),
K5 (``encode_m``) and K3 (``decode``), each a CUDA kernel with its plain
PyTorch version beside it, and the word/byte helpers and the plain coder
(``coder``)."""

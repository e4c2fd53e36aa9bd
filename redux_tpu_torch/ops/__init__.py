"""The port's device operations: K1 (``model``), K2 (``encode``) and K3
(``decode``), each a CUDA kernel with its plain PyTorch version beside it,
and the word/byte helpers (``coder``)."""

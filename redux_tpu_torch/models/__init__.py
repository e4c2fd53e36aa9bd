"""Model initialisation for the PyTorch port (counterpart: ``redux_tpu/models``)."""

"""ops of the PyTorch port."""

"""Transfer backends of the PyTorch port: ``transfer`` (dense reference) and
``stream_transfer`` (tile-binned stream; kernels in ``stream_kernels``)."""

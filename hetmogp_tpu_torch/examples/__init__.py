"""The JAX package's examples on the port, run as modules:
``python -m hetmogp_tpu_torch.examples.<name> --device cpu|cuda``."""

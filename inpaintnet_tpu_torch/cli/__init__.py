"""The port's entry points, ``python -m inpaintnet_tpu_torch.cli.<name>``:
twins of the JAX package's root scripts (argparse, not click; the same
flags, defaults and help, and ``--device``)."""

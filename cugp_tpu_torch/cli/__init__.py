"""The port's command-line interface: ``python -m cugp_tpu_torch.cli`` (see
``__main__``)."""

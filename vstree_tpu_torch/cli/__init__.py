"""Entry points of the port: ``python -m vstree_tpu_torch.cli.mkvtree`` and
``python -m vstree_tpu_torch.cli.vmatch``."""

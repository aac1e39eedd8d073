"""Architecture configs and shape cells (``base``), one module per arch
with ``CONFIG`` and ``SMOKE``, and the ``--arch`` registry."""

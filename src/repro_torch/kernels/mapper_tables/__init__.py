"""The mapper's candidate tables on the card: ``kernel.py`` (the wrapper of
``csrc/mapper_tables.cu``), ``ref.py`` (the plain PyTorch version) and
``ops.py`` (``chunk_tables``, numpy in and numpy out, on the card)."""

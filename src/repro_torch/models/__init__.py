"""LM stack of the port (the ``dense`` and ``ssm`` families so far), as
``repro.models``."""

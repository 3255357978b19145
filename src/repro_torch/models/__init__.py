"""LM stack of the port (``ssm`` family so far), as ``repro.models``."""

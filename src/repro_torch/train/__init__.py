"""The training loop of the port, as ``repro.train``."""
from repro_torch.train.loop import StragglerMonitor, TrainLoop

__all__ = ["StragglerMonitor", "TrainLoop"]

"""The port's user tools: the game launcher, the live viewer, the replay
exporter and the ``pf`` API listing, each run as
``python -m permafrost_engine_tpu_torch.tools.<name>``."""

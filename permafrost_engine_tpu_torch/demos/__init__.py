"""The port's demos: the JAX package's ``demos/`` on the port, each run as
``python -m permafrost_engine_tpu_torch.demos.<name>``, on the card unless
``--cpu`` asks for the CPU."""

"""Optimizers of the port (the reference's src/repro/optim/)."""

"""Training for the port: ``parallel/train.py`` holds the RNNoise training
net and step.

The JAX package's mesh helpers (``make_mesh``, ``data_sharding``,
``replicated``, ``model_sharding``) and its DP x TP sharding of the training
step wait for the port's multi-GPU slice (ROADMAP item 12c); the port
trains on one card.
"""
